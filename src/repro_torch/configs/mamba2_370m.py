"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060; unverified]
(copy of ``repro.configs.mamba2_370m``).

48L d_model=1024, attention-free (d_ff=0: no FFN, the Mamba-2 block is the
whole layer), vocab 50280 (GPT-NeoX tokenizer), ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, SSMSpec, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,          # = d_inner / head_dim (SSD heads)
    n_kv_heads=32,
    d_head=64,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssm",),
    mlp_pattern=("mlp",),
    ssm=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                chunk=256),
    tie_embeddings=True,
))
