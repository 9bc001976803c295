"""How often a torch.profiler trace of the device loses records, and where.

Traces 100 calls of each of three functions (``F.rms_norm``, SDPA, a plain
RMSNorm of 8 launches) N times under three variants: as chip_smoke.py's
``device_ms`` traces them ("plain"), with a synchronize and a 2 ms pause
inside the trace before the calls ("pause"), and with a spin kernel before
and after the calls ("marker": a loss at a trace's ends takes a marker,
not a call's record).  Prints, per function and variant, the traces that
lost records (trace index, records of the calls kept, markers kept) and
the longest run of lossy traces in a row.

    python3 chip_trace_probe.py [N]      # N traces a variant, default 200

Needs one CUDA card.
"""
import sys
import time


def main(n=200, iters=100):
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_trace_probe: needs a CUDA device", file=sys.stderr)
        return 1
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(384, 2048, device="cuda", dtype=torch.bfloat16,
                    generator=g)
    w = torch.ones(2048, device="cuda")
    q = torch.randn(1, 16, 384, 128, device="cuda", dtype=torch.bfloat16,
                    generator=g)
    k = torch.randn(1, 8, 384, 128, device="cuda", dtype=torch.bfloat16,
                    generator=g)

    def plain():
        xf = x.float()
        return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
                * w).to(x.dtype)

    fns = {"rms_norm": lambda: F.rms_norm(x, (2048,), w.to(x.dtype)),
           "sdpa": lambda: F.scaled_dot_product_attention(
               q, k, k, is_causal=True, enable_gqa=True),
           "plain": plain}

    def trace(fn, calls, variant):
        """Names of the device activities of ``calls`` calls, markers
        apart: (names of the calls' records, markers kept)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if variant == "marker":
                torch.cuda._sleep(1000)
            if variant == "pause":
                torch.cuda.synchronize()
                time.sleep(0.002)
            for _ in range(calls):
                fn()
            if variant == "marker":
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        body = [s for s in names if "spin" not in s.lower()
                and "sleep" not in s.lower()]
        return body, len(names) - len(body)

    for name, fn in fns.items():
        for _ in range(10):
            fn()
        per = len(trace(fn, 1, "plain")[0])
        print(f"{name}: {per} device activities a call", flush=True)
        for variant in ("plain", "pause", "marker"):
            lossy, streak, longest = [], 0, 0
            t0 = time.time()
            for i in range(n):
                body, marks = trace(fn, iters, variant)
                streak = 0 if len(body) == per * iters else streak + 1
                longest = max(longest, streak)
                if streak:
                    lossy.append((i, len(body), marks))
            print(f"  {variant}: {len(lossy)}/{n} traces lost records, "
                  f"longest streak {longest}, {time.time() - t0:.1f} s; "
                  f"{lossy[:12]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 200))
