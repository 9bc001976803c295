"""qwen1.5-4b — QKV bias [hf:Qwen/Qwen1.5-4B; hf] (copy of
``repro.configs.qwen15_4b``).

40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936; biases on Q/K/V
projections (Qwen signature).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_head=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=5_000_000.0,
))
