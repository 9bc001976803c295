"""Model configuration system (copy of ``repro.configs.base``).

The JAX package's ``repro.configs`` imports jax through ``shapes.py``, so
the port keeps its own copy of the dataclasses, the registry and
:func:`reduced_config`.  ``tests/test_torch_configs.py`` holds each copy
equal to the original under ``dataclasses.asdict``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# --------------------------------------------------------------------------
# Sub-specs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts FFN spec (GShard-style top-k with capacity)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # qwen3-style: softmax over the selected top-k logits (renormalized);
    # if False: softmax over all experts then select (switch-style).
    norm_topk_prob: bool = True
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba-2 SSD spec."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MLASpec:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Encoder stack for enc-dec models (whisper).  Bidirectional attention."""

    n_layers: int = 6
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 2048
    # Number of (precomputed, stubbed) frontend frames fed to the encoder.
    source_len: int = 1500


# --------------------------------------------------------------------------
# Main config
# --------------------------------------------------------------------------

MIXERS = ("attn", "attn_local", "ssm")
MLPS = ("mlp", "moe")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # Layer pattern: one *period* of mixer kinds / mlp kinds; the model is
    # ``n_layers // len(pattern)`` stacked periods plus an unrolled remainder
    # of ``pattern[: n_layers % len(pattern)]``.
    layer_pattern: Tuple[str, ...] = ("attn",)
    mlp_pattern: Tuple[str, ...] = ("mlp",)

    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None
    embed_scale: float = 1.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_window: Optional[int] = None  # window for 'attn_local' layers
    attn_logit_softcap: Optional[float] = None
    act: str = "swiglu"  # swiglu | gelu

    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    mla: Optional[MLASpec] = None
    encoder: Optional[EncoderSpec] = None

    # Modality frontend stub: 'none' | 'patch_stub' (vlm) | 'audio_stub'.
    frontend: str = "none"
    frontend_len: int = 0

    dtype: str = "bfloat16"
    loss_chunk: int = 512
    # Query-chunk size of chunked (non-kernel) attention.
    attn_chunk: int = 1024
    remat: str = "full"
    opt_dtype: str = "float32"

    # ---------------------------------------------------------------- helpers
    def __post_init__(self):
        if self.family not in ("dense", "ssm", "moe", "hybrid", "vlm", "audio"):
            raise ValueError(f"unknown family {self.family!r}")
        if len(self.layer_pattern) != len(self.mlp_pattern):
            raise ValueError("layer_pattern and mlp_pattern differ in length")
        for m in self.layer_pattern:
            if m not in MIXERS:
                raise ValueError(f"unknown mixer {m!r}")
        for m in self.mlp_pattern:
            if m not in MLPS:
                raise ValueError(f"unknown mlp {m!r}")
        if "ssm" in self.layer_pattern and self.ssm is None:
            raise ValueError("ssm layers need an SSMSpec")
        if "moe" in self.mlp_pattern and self.moe is None:
            raise ValueError("moe layers need a MoESpec")
        if "attn_local" in self.layer_pattern and self.attn_window is None:
            raise ValueError("attn_local layers need attn_window")

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def n_remainder(self) -> int:
        return self.n_layers % self.period

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def uses_attention(self) -> bool:
        return any(m.startswith("attn") for m in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run long_500k (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    # -------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Exact parameter count (matches init_params; used for 6ND)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Active (per-token) parameters, for MoE 6·N_active·D."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    import repro_torch.configs.archs  # noqa: F401  (registers every arch)


# --------------------------------------------------------------------------
# Reduced configs for CPU tests
# --------------------------------------------------------------------------


def reduced_config(name_or_cfg) -> ModelConfig:
    """A tiny config of the *same family / layer pattern* for CPU tests.

    Keeps the period structure while shrinking widths, depth, vocab and
    experts — field for field as ``repro.configs.base.reduced_config``.
    """
    cfg = name_or_cfg if isinstance(name_or_cfg, ModelConfig) else get_config(name_or_cfg)
    period = cfg.period
    n_layers = period + min(cfg.n_remainder, 1)
    d_model = 64
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32,
            capacity_factor=4.0)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    mla = None
    if cfg.mla is not None:
        mla = MLASpec(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                      qk_rope_head_dim=8, v_head_dim=8)
    enc = None
    if cfg.encoder is not None:
        enc = EncoderSpec(n_layers=2, n_heads=4, n_kv_heads=4, d_ff=64,
                          source_len=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        embed_scale=math.sqrt(d_model) if cfg.embed_scale != 1.0 else 1.0,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        moe=moe,
        ssm=ssm,
        mla=mla,
        encoder=enc,
        attn_window=min(cfg.attn_window, 8) if cfg.attn_window else None,
        frontend_len=8 if cfg.frontend != "none" else 0,
        loss_chunk=32,
        attn_chunk=16,
        dtype="float32",
        remat="none",
    )
