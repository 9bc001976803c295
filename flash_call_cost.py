"""Host and device cost of one causal bf16 flash-attention call, at the
shapes that chip_smoke.py phase 3 times, for the ``repro_torch`` of a given
checkout.

At each shape it prints, for the kernel and for SDPA, the CUDA-event time
of a call (back-to-back calls, the host's launch included: where the host
cannot keep ahead of the kernel, this is the host's cost of a call) and
the device time from a torch.profiler trace, then one JSON line of them
all.  Serves are host-bound, so this is how two versions of the wrapper
compare in what a call costs the host.  Run it on two checkouts one after
the other on one card, in the order A B B A:

    python3 flash_call_cost.py [CHECKOUT]   # default: this checkout

Needs one CUDA card; builds the checkout's flash kernel into the
checkout's ``build/kernels``.
"""
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(checkout=HERE):
    checkout = Path(checkout).resolve()
    if not (checkout / "src" / "repro_torch").is_dir():
        print(f"flash_call_cost: {checkout} holds no src/repro_torch",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(checkout / "src"))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_call_cost: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fa

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    print(cs.nvidia_smi_line())
    print(f"repro_torch from {checkout}; torch {torch.__version__}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for H, Hk, B, S, D in cs.FLASH_BF16_SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        q, k, v = randn(B, S, H, D), randn(B, S, Hk, D), randn(B, S, Hk, D)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fns = {"kernel": lambda: fa.flash_attention_bshd(q, k, v),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=H != Hk)}
        row = dict(B=B, S=S, H=H, Hk=Hk, D=D)
        for name, fn in fns.items():
            row[f"{name}_event_ms"] = cs.cuda_ms(fn)
            row[f"{name}_device_ms"] = cs.device_ms(fn)[0]
        rows.append(row)
        print(f"B{B} S{S} H{H} Hk{Hk} D{D}: kernel "
              f"{row['kernel_event_ms']:.5f} ms a call by events, "
              f"{row['kernel_device_ms']:.5f} ms device; sdpa "
              f"{row['sdpa_event_ms']:.5f}, {row['sdpa_device_ms']:.5f} ms",
              flush=True)
    print(json.dumps({"checkout": str(checkout), "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
