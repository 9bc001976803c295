"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE [arXiv:2403.19887; hf]
(copy of ``repro.configs.jamba15_large``).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; MoE (16 experts,
top-2) every other layer; attention every 8th layer (1:7 attn:mamba).
As in the reference, the SSM layers are Mamba-2 (SSD) layers with
d_state=16 and head_dim=64.  Optimizer moments are bf16 (``opt_dtype``).
"""
from repro_torch.configs.base import ModelConfig, MoESpec, SSMSpec, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=65536,
    # period of 8: attention at position 4, mamba elsewhere; MoE on odd slots
    layer_pattern=("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"),
    mlp_pattern=("mlp", "moe", "mlp", "moe", "mlp", "moe", "mlp", "moe"),
    moe=MoESpec(n_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMSpec(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
                chunk=256),
    opt_dtype="bfloat16",
))
