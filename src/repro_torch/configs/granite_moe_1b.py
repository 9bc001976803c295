"""granite-moe-1b-a400m — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
(copy of ``repro.configs.granite_moe_1b``).

24L d_model=1024 16H (GQA kv=8) vocab=49155; every layer MoE with 32
experts, top-8, expert d_ff=512.
"""
from repro_torch.configs.base import ModelConfig, MoESpec, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    layer_pattern=("attn",),
    mlp_pattern=("moe",),
    moe=MoESpec(n_experts=32, top_k=8, d_ff_expert=512, norm_topk_prob=True),
    tie_embeddings=True,
))
