"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]
(copy of ``repro.configs.qwen3_moe_30b``).

48L d_model=2048 32H (GQA kv=4) vocab=151936; every layer MoE with 128
experts, top-8, expert d_ff=768, renormalized top-k routing.

The port runs it reduced only (``reduced_config``, on the CPU): at full
size its 30.5B parameters' train state does not fit one card.
"""
from repro_torch.configs.base import ModelConfig, MoESpec, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    layer_pattern=("attn",),
    mlp_pattern=("moe",),
    moe=MoESpec(n_experts=128, top_k=8, d_ff_expert=768, norm_topk_prob=True),
))
