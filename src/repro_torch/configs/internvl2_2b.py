"""internvl2-2b — InternViT + InternLM2 [arXiv:2404.16821; hf] (copy of
``repro.configs.internvl2_2b``).

LM backbone only (InternLM2-1.8B-style decoder): 24L d_model=2048 16H
(GQA kv=8) d_ff=8192 vocab=92553.  The InternViT frontend is a stub: 256
precomputed patch embeddings are prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    frontend="patch_stub",
    frontend_len=256,
))
