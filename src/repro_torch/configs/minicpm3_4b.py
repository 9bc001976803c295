"""minicpm3-4b — MLA [hf:openbmb/MiniCPM3-4B; hf] (copy of
``repro.configs.minicpm3_4b``).

62L d_model=2560 40H d_ff=6400 vocab=73448; multi-head latent attention with
q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32 (per HF config).
Decode uses the absorbed-latent form (cache = compressed c_kv + rope key).
"""
from repro_torch.configs.base import MLASpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=96,           # qk head dim (nope 64 + rope 32)
    d_ff=6400,
    vocab_size=73448,
    mla=MLASpec(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                qk_rope_head_dim=32, v_head_dim=64),
))
