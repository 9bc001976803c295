"""gemma3-1b — 5:1 local:global attention [hf:google/gemma-3-1b-pt;
unverified] (copy of ``repro.configs.gemma3_1b``).

26L d_model=1152 4H (GQA kv=1, head_dim=256) d_ff=6912 vocab=262144.
Pattern: 5 sliding-window (512) layers then 1 global layer; 26 = 4 periods
of 6 + 2 trailing local layers.  Local layers use rope base 10k, global
layers 1M.  Tied embeddings scaled by sqrt(d_model).
"""
import math

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab_size=262144,
    layer_pattern=("attn_local",) * 5 + ("attn",),
    mlp_pattern=("mlp",) * 6,
    attn_window=512,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    tie_embeddings=True,
    embed_scale=math.sqrt(1152.0),
    act="geglu",
))
