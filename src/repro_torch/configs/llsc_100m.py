"""llsc-100m — the paper's own demo workload (copy of
``repro.configs.llsc_100m``): a ~138M-parameter dense LM, the stand-in for
"a user's job" in the monitoring examples."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llsc-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=32768,
    tie_embeddings=True,
))
