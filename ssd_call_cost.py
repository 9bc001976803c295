"""Host and device cost of one SSD intra-chunk call (bf16 x, B, C; fp32 y),
at the main paths' shapes that chip_smoke.py phase 3 times, for the
``repro_torch`` of a given checkout.

At each shape it prints the CUDA-event time of a call (back-to-back calls,
the host's launch included: where the host cannot keep ahead of the
kernel, this is the host's cost of a call), the host's time to issue a
call (``time.perf_counter`` around the same calls, no wait for the card)
and the device time from a torch.profiler trace, then one JSON line of
them all.  Serves are host-bound, so this is how two versions of the
wrapper compare in what a call costs the host, and how their bodies
compare on the card.  Run it on two checkouts one after the other on one
card, in the order A B B A:

    python3 ssd_call_cost.py [CHECKOUT]   # default: this checkout

Needs one CUDA card; builds the checkout's SSD kernel into the checkout's
``build/kernels``.
"""
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# (label, N, l, h, p, g, n, views): views hands x, B, C over as slices of
# one conv output, as the models do
SHAPES = (("mamba2-370m serve", 2, 256, 32, 64, 1, 128, False),
          ("mamba2-370m serve, the model's views", 2, 256, 32, 64, 1, 128,
           True),
          ("jamba chunk, the model's views", 1, 256, 256, 64, 1, 16, True),
          ("mamba2-370m train step", 8, 256, 32, 64, 1, 128, False))


def host_ms(torch, fn, iters=200, warmup=20):
    """Mean host time to issue one call, back to back, without waiting for
    the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / iters * 1e3


def main(checkout=HERE):
    checkout = Path(checkout).resolve()
    if not (checkout / "src" / "repro_torch").is_dir():
        print(f"ssd_call_cost: {checkout} holds no src/repro_torch",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(checkout / "src"))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ssd_call_cost: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ssd

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    print(cs.nvidia_smi_line())
    print(f"repro_torch from {checkout}; torch {torch.__version__}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, N, l, h, p, g, n, views in SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        width = h * p + 2 * g * n
        xbc = randn(N, l, width if views else h * p).to(torch.bfloat16)
        x = xbc[..., :h * p].unflatten(-1, (h, p))
        if views:
            B = xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n))
            C = xbc[..., h * p + g * n:].unflatten(-1, (g, n))
        else:
            B = randn(N, l, g, n).to(torch.bfloat16)
            C = randn(N, l, g, n).to(torch.bfloat16)
        dt = F.softplus(randn(N, l, h))
        A = -torch.exp(randn(h) * 0.3)

        def fn():
            return ssd.ssd_intra_chunk(x, dt, A, B, C,
                                       out_dtype=torch.float32)

        fn()
        row = dict(shape=label, N=N, l=l, h=h, p=p, g=g, n=n,
                   body=getattr(ssd, "body", None),
                   heads_per_block=ssd.heads_per_block,
                   event_ms=cs.cuda_ms(fn), host_ms=host_ms(torch, fn),
                   device_ms=cs.device_ms(fn)[0])
        rows.append(row)
        print(f"{label} (body {row['body']}, heads a block "
              f"{row['heads_per_block']}): {row['event_ms']:.5f} ms a call "
              f"by events, host {row['host_ms']:.5f} ms to issue, device "
              f"{row['device_ms']:.5f} ms", flush=True)
    print(json.dumps({"checkout": str(checkout), "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
