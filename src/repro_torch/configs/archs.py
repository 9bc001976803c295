"""Import side-effects: registers every architecture config (counterpart
of ``repro.configs.archs``)."""
import repro_torch.configs.gemma3_1b       # noqa: F401
import repro_torch.configs.granite_moe_1b  # noqa: F401
import repro_torch.configs.internvl2_2b    # noqa: F401
import repro_torch.configs.jamba15_large   # noqa: F401
import repro_torch.configs.llsc_100m       # noqa: F401
import repro_torch.configs.mamba2_370m     # noqa: F401
import repro_torch.configs.minicpm3_4b     # noqa: F401
import repro_torch.configs.phi3_medium_14b # noqa: F401
import repro_torch.configs.qwen15_4b       # noqa: F401
import repro_torch.configs.qwen3_moe_30b   # noqa: F401
import repro_torch.configs.whisper_base    # noqa: F401

# The 10 assigned architectures (llsc-100m is the paper's own demo extra).
ASSIGNED = (
    "mamba2-370m",
    "internvl2-2b",
    "minicpm3-4b",
    "qwen1.5-4b",
    "phi3-medium-14b",
    "gemma3-1b",
    "jamba-1.5-large-398b",
    "whisper-base",
    "qwen3-moe-30b-a3b",
    "granite-moe-1b-a400m",
)
