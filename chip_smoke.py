#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports nothing of JAX or of the JAX package.  Phases:

1. the card (name and power limit from nvidia-smi) and the versions;
2. build the three CUDA sources from ``src/repro_torch/kernels/csrc`` with
   nvcc (flash attention; RMSNorm and gated RMSNorm; SSD intra-chunk), one
   process per source, started together, and print each kernel
   instance's ptxas registers and spills, the tile, stages and dynamic
   shared memory of the Hopper flash body's six instances, and the
   registers and shared memory of the Hopper SSD body's four (none of
   either may spill);
3. hold each of the four kernels against its plain PyTorch version on the
   card on the test sweeps and at the main paths' shapes (tolerance 2e-5 in
   float32 and 2e-2 in bfloat16 for attention and the norms, 2e-4 for the
   SSD block, computed in float32 from either input dtype, as
   |a - b| <= atol + rtol * |b|), with a long sequence (S = T = 1024) for
   flash attention, flash at D = 16 and 256 with ragged S and T and a
   causal S = T = 1024 and 1280 at D = 256, bfloat16 norms with a float32
   scale, rows off 16-byte
   alignment for both norms (their scalar bodies), and the SSD block (each
   call's body checked through ``ssd.body``: the Hopper body at every main
   path's shape, float32 y within 2e-4 and bfloat16 y within 2e-2, ragged
   chunks among them) on the model's strided views, on B, C off 16-byte
   alignment (its CUDA-core body) and at full width on the draw of the
   CPU emulation of its arithmetic, against float64; check that the plain
   version's float32 cumsum sums left to right on the card, bit for bit,
   that a bfloat16 flash input that is not 16-byte aligned raises, and
   that each of the five raw kernel wrappers raises under autograd without
   launching; then time kernel, plain version and the library call where
   one exists (device
   time from torch.profiler's kernel records, with the CUDA-event time of
   a call beside it, the host's cost of a call where the host cannot keep
   ahead) against the data-sheet bound, with flash's plan (mode, tile,
   stages, grid), TFLOP/s, share of the bound and ratio to SDPA at each
   shape, and the wgmma body's other mode checked and timed beside the
   plan's where the shape's 128-row work tiles lie within a factor of 2
   of the card's SM count (the evidence for the plan's rule, whose time
   the phase prints): flash attention at
   reduced gemma3's D = 16 (S = 64), at gemma3-1b's 4 query and 1 KV head
   of 256 (S = 256 and 640, and a train step's 8 x 256), at S = 128 and
   256 (jamba's 64 query and 8 KV heads of 128 among them), RMSNorm at
   gemma3's rows of 1152, jamba's of 8192, llsc-100m's of 768 and
   mamba2-370m's of 1024, the gated norm at 4 and 256 rows of jamba's
   16384 and 4 and
   320 rows of 2048, the SSD block at jamba's chunk of 256 heads, at two
   chunks of mamba2-370m and at its train step's 8 (each at most 0.8x of
   the mma.sync body's time, ``SSD_MMA_MS``); the gated norm refuses a row of
   16385;
   flash at qwen1.5-4b's 20 heads of 128 and phi3-medium-14b's 40 query
   and 10 KV heads of 128 (S = 128 and 256, and qwen's train step), timed
   against SDPA with ``enable_gqa``; RMSNorm at
   rows of 2560 (qwen1.5, minicpm3), 5120 (phi3, the scalar body), 768
   and 256 (minicpm3's q_norm and kv_norm), and kv_norm's input as it is,
   256 of rows 288 apart (and 289: the scalar body), timed against
   ``F.rms_norm``; flash at whisper-base's 8 heads of 64 (B1 S128, and a
   train step's B8 S256) and internvl2-2b's 16 query and 8 KV heads of 128
   (S = 384 and 512, and a train step's B8 S512), against SDPA; RMSNorm at
   whisper-base's rows of 512 (4 and 6000: the encoder of 4 requests) and
   internvl2-2b's of 2048 (4 and 384), against ``F.rms_norm``;
4. serve llsc-100m at full width and depth in bfloat16 with
   ``flash_kernel`` on through ``ServeEngine``: 8 requests (prompts of 128
   and 256 tokens, 32 new tokens each) through 4 slots, after a warm-up of
   4 requests of 8 new tokens (as every serve of phases 7, 19, 25 and 30);
   the kernels' launch counters are set to 0 just before and must read
   exactly
   flash = 12 x prefills, rmsnorm = 25 x (prefills + decode steps) and
   no gated norm or SSD launch;
5. float32 logits of the card against the CPU over a prefill and 8 greedy
   decode steps of llsc-100m at full width (tolerance 1e-4, the same
   tokens); then the card once more with every RMSNorm on its scalar body
   (inputs one element off 16-byte alignment), to show how much of the
   error is the vector body's order of summation;
6. the first 4 requests of 4 (one wave through the 4 slots, 32 new
   tokens each), untraced and then under ``torch.profiler``, tracing the
   device alone (``profile_wave``): device busy share (device time over the
   span from the trace's first device activity to its last), the device
   totals of the flash-attention and RMSNorm kernels, and the largest kernels;
7. serve mamba2-370m at full width and depth in bfloat16: 8 requests
   (prompts of 128 and 320 tokens: one padded chunk of 256, and two; 32 new
   tokens each) through 4 slots, ``max_seq_len`` 384; the counters read
   exactly rmsnorm = 49 x (prefills + decode steps), gated = 48 x
   (prefills + decode steps), ssd = 48 x prefills and flash = 0;
8. float32 logits of the card against the CPU over a 320-token prefill
   and 8 greedy decode steps of mamba2-370m at full width (tolerance 1e-4,
   the same tokens; every cumsum accumulates in float32, as the
   reference's);
9. the first 4 requests of 7 under ``torch.profiler``, as 6, with the
   totals of the
   RMSNorm, gated RMSNorm and SSD kernels;
10. the five ``kernels.ops`` entry points with inputs that require grad,
    in float32 and bfloat16: one launch each through its autograd
    Function, none in the backward, and the output and every gradient
    against the plain route's within phase 3's tolerances;
11. train llsc-100m at full width and depth in bfloat16 (float32 masters)
    through ``launch.train.main``: 8 AdamW steps of 8 x 256 tokens with
    ``flash_kernel`` under the config's ``remat = "full"``, counters set to
    0 just before and reading exactly flash = 24 x steps and rmsnorm = 49 x
    steps (every block's kernels run again in the backward's recompute; the
    final norm once); finite losses, the registry's duty in (0, 1], the
    median step time and tokens/s of steps 3-8, and peak memory;
12. one train step under ``torch.profiler``: the device time of flash,
    RMSNorm, the GEMMs, the plain-version backwards of attention and
    RMSNorm, and the rest, and the busy share;
13. llsc-100m training in float32 at full width on the card and on the
    CPU, 2 steps on one batch from the same masters: losses within 1e-4
    relative, step-1 gradients within 5e-3 and each leaf's within 1e-4 of
    its largest, parameters where the step-1 gradient is at least 1e-2 of
    its leaf's largest within 1e-2 (lr_1 + lr_2) plus their rounding, and
    elsewhere within 2 (lr_1 + lr_2) + 1e-6;
14. train mamba2-370m at full width and depth as 11 (no flash): rmsnorm =
    97, gated = 96 and ssd = 96 launches a step, no flash;
15. one mamba2-370m train step under ``torch.profiler``, as 12, with the
    SSD, gated-norm and RMSNorm kernels and plain-version backwards;
16. mamba2-370m training in float32 on the card and on the CPU, as 13, at
    full width and 4 of its 48 layers (the CPU side's time);
17. one llsc-100m forward and backward at full width in bfloat16 under
    remat "none", "full" and "dots" from the same masters and batch: the
    same loss, gradients within 13's bounds, exact launches, peak memory
    under "full" below "none"'s; the three peaks and times;
18. checkpoint, crash and resume on the card (llsc-100m, 8 steps, a
    checkpoint every 2, a crash at step 5): the latest step is 4, the
    restored state equals the saved one bit for bit, the resume starts at
    4 and ends at the uninterrupted final loss within 1e-4 relative, an
    async save writes the same files; save and restore times, bytes;
19. after a collection and ``empty_cache`` (memory allocated printed),
    serve granite-moe-1b-a400m (mixture of experts: 32 experts, top-8, in
    every one of 24 layers; 16 query and 8 KV heads of 64) at full width
    and depth in bfloat16 as 4 serves llsc-100m, host-side init timed:
    flash = 24 x prefills, rmsnorm = 49 x (prefills + decode steps), no
    gated norm or SSD; the published duty counts the active parameters
    (428,658,688 of 1,334,628,352);
20. float32 logits of the card against the CPU over a 128-token prefill
    (tokens drop: capacity 40) and 8 greedy decode steps of
    granite-moe-1b-a400m at full width and 4 of its 24 layers (tolerance
    1e-4, the same tokens), with every layer's top-k expert ids the same on
    both sides (flips counted; the gap of the k-th and (k+1)-th router
    logit printed at each);
21. the first 4 of 19's requests (one wave through the 4 slots), cut to 4
    new tokens each, under ``torch.profiler``, as 6, with the device time
    of the MoE's parts:
    routing, the sort, the scatter, the expert products and the combine
    (labels need the host's operators in the trace, which then takes
    minutes to read over all 8 requests);
22. train granite-moe-1b-a400m at full width and depth as 11 (48 flash
    and 97 RMSNorm launches a step), the host-side init timed apart;
23. one granite train step under ``torch.profiler``, as 12, with the
    MoE's forward parts and the stacked leaves' select backward;
24. granite-moe-1b-a400m training in float32 on the card and on the CPU,
    as 13, at full width and 4 of its 24 layers, with the MoE auxiliary
    losses at (0.01, 1e-3);
25. after a collection and ``empty_cache``, serve jamba-1.5-large-398b
    (the hybrid: Mamba-2 layers, an attention layer of 64 query and 8 KV
    heads of 128, 16-expert top-2 MoEs on the odd slots) at full width and
    5 of its 72 layers (23,984,828,032 parameters, 47.97 GB in bf16, drawn
    on the card from a CUDA generator, the init timed) in bfloat16 as 4
    serves llsc-100m: flash 1 and SSD 4 a prefill, the gated norm 4 and
    RMSNorm 11 a prefill or decode step;
26. the first 4 requests of 25 under ``torch.profiler``, as 6 with the
    MoE's parts labelled as 21, and one decode
    step's device time against the HBM time of the weights it reads;
27. float32 at full width, card against CPU within 1e-4: the model at 1
    layer over a 128-token prefill and 8 greedy decode steps, and the
    attention block of slot 4 alone through ``apply_block_full`` and 8
    ``apply_block_decode`` steps on its KV cache;
28. reduced jamba (one period of 8) in float32, card against CPU with
    ``flash_kernel`` (the fp32 body at its d_head of 16): prefill and
    decode logits, then 2 train steps with bf16 moments and aux losses, as
    13, with no expert-route flip;
29. ``launch.serve`` and ``launch.train`` (20 steps) of reduced jamba on
    the card exit 0;
30. after a collection and ``empty_cache``, serve gemma3-1b (4 periods of
    5 sliding-window layers of window 512 and a global layer, 2 local
    remainder layers; 4 query heads and 1 KV head of 256; GeGLU; vocab
    262144, tied) at full width and depth in bfloat16 with
    ``flash_kernel`` (999,812,736 parameters drawn on the card): prompts
    of 256 and 640 tokens, 32 new tokens each, ``max_seq_len`` 768, so
    the long requests decode past the window; flash = 4 x prefills (the
    global layers only), rmsnorm = 53 x (prefills + decode steps);
31. the first 4 requests of 30 under ``torch.profiler``, as 6;
32. train gemma3-1b at full width and depth as 11 (8 flash and 101
    RMSNorm launches a step: the 4 global layers lie in the stacked
    periods and are recomputed);
33. one gemma3-1b train step under ``torch.profiler``, as 12;
34. float32 at full width and 6 of 26 layers (one period), card against
    CPU within 1e-4: a 640-token prefill and 8 greedy decode steps past
    the window, the same tokens; a 1280-token forward (past the 1024-row
    ``attn_chunk``) with and without ``banded_local``, hidden states and
    logits against the CPU's and against each other; 2 train steps, as 13;
35. reduced gemma3 in float32 with ``flash_kernel`` and ``banded_local``,
    card against CPU: prefill and decode logits, then 2 train steps; and
    ``launch.serve`` and ``launch.train`` (20 steps) of reduced gemma3
    exit 0;
36. after a collection and ``empty_cache``, serve qwen1.5-4b (40 layers
    of 20 heads of 128 with QKV biases; 3,950,369,280 parameters drawn on
    the card) at full width and depth in bfloat16 with ``flash_kernel``
    after a warm-up of 2 requests: prompts of 128 and 256 tokens, 32 new
    tokens each, ``max_seq_len`` 384; flash = 40 x prefills, rmsnorm = 81
    x (prefills + decode steps);
    one decode step's device time against the HBM time of its weights;
37. the same for phi3-medium-14b (40 query and 10 KV heads of 128;
    14,659,507,200 parameters, 29.3 GB in bf16);
38. a serve of the first 4 of 37's requests, cut to 4 new tokens each,
    under ``torch.profiler``, as 6, with attention's prefill and decode
    and the FFN under
    ``record_function`` labels;
39. the same as 36 for minicpm3-4b (62 MLA layers; 4,261,902,848
    parameters): no flash (MLA takes chunked attention, as the
    reference's), rmsnorm = 249 x (prefills + decode steps): ln1, ln2,
    q_norm and kv_norm a layer and the final norm;
40. train qwen1.5-4b at full width and 8 of its 40 layers through
    ``launch.train.main`` (its config cut to 8 layers), as 11 with
    ``flash_kernel``: 16 flash and 33 RMSNorm launches a step;
41. one qwen1.5-4b train step under ``torch.profiler``, as 12;
42. train minicpm3-4b at full width and 8 of its 62 layers the same way:
    no flash, 65 RMSNorm launches a step;
43. one minicpm3-4b train step under ``torch.profiler``, as 12;
44. float32 at full width and 1 layer, the biases and norm scales planted
    with nonzero values and values other than one on both sides, card
    against CPU within 1e-4: a 256-token prefill and 8 greedy decode steps
    of each of the three, the same tokens; minicpm3-4b's absorbed decode
    against a naive forward over the same tokens on the card; 2 train
    steps of qwen1.5-4b and minicpm3-4b, as 13;
45. reduced qwen1.5-4b, phi3-medium-14b and minicpm3-4b in float32 with
    ``flash_kernel``, planted, card against CPU: prefill and decode
    logits, then 2 train steps; and ``launch.serve`` and ``launch.train``
    (20 steps) of each, reduced, exit 0;
46. after a collection and ``empty_cache``, serve whisper-base
    (encoder-decoder: 6 encoder layers over 1500 frames, 6 decoder layers
    with cross attention; 97,166,336 parameters drawn on the card) at full
    width and depth in bfloat16 with ``flash_kernel`` at the model level,
    as the reference's tests serve it (its engine takes no frames): 2
    batches of 4 requests, each 1500 frames of ``SyntheticLM.frontend``
    and a prompt of 128 (one batch) or 256 tokens (the other), 32 greedy
    new tokens each (the prefill's and 31 decode steps); flash = 6 x
    prefills (the decoder's self-attention; the encoder's attention and
    the cross attention are chunked, as the reference's), rmsnorm = 32 x
    prefills (13 in the encoder) + 19 x decode steps; tokens/s, prefill,
    decode and encoder ms, peak memory; one decode step's device time
    against the HBM time of the decoder's and head's weights and the
    cross-attention keys and values it reads;
47. serve internvl2-2b (24 layers of 16 query and 8 KV heads of 128;
    1,889,146,880 parameters drawn on the card) at full width and depth
    through ``ServeEngine``, text only as the reference's, as 36: flash =
    24 x prefills, rmsnorm = 49 x (prefills + decode steps); one decode
    step against its weights' HBM time;
48. internvl2-2b at the model level, as 46: 4 requests of 256 patches and
    128 tokens (384 positions: flash takes them), 32 new tokens each;
49. train whisper-base at full width and depth through
    ``launch.train.main`` as 11, 8 x 1500 frames and 8 x 256 tokens a
    step: 12 flash and 50 RMSNorm launches a step (the encoder's 13 run
    once: it lies outside the rematerialized periods);
50. one whisper-base train step under ``torch.profiler``, as 12;
51. train internvl2-2b at full width and depth the same way, 8 x 256
    patches before 8 x 256 tokens a step (512 positions): 48 flash and 97
    RMSNorm launches a step;
52. one internvl2-2b train step under ``torch.profiler``, as 12;
53. float32, norm scales planted, card against CPU within 1e-4:
    whisper-base at full width and depth (a prefill of 1500 frames and
    128 tokens, 8 greedy decode steps; 2 train steps, gradients within
    1e-4 of each leaf's largest, the encoder's among them) and
    internvl2-2b at full width and 1 layer (256 patches) the same;
54. reduced whisper-base and internvl2-2b in float32 with
    ``flash_kernel``, planted, card against CPU: prefill and decode
    logits, then 2 train steps; ``launch.train`` (20 steps) of each and
    ``launch.serve`` of internvl2 exit 0; ``launch.serve`` of whisper
    exits 1 with the port's message;
55. serve llsc-100m at full width and depth in bfloat16 with
    ``flash_kernel`` as 4, in turns greedy, sampled (temperature 0.8, top
    40, seed 0), ``top_k=1``, greedy, sampled: tokens/s and decode ms a
    step of each; the launches exactly ``serve_launches``; the two sampled
    serves give the same tokens, ``top_k=1`` greedy's; the draws
    come from a CUDA generator; at the model level 8 decode steps of 4
    rows whose drawn tokens all lie in the top 40 of their logits;
56. reduced gemma3-1b in float32 with ``flash_kernel``:
    ``make_train_step(banded=True)`` and ``loss_and_grads(banded=True)``
    against the ``banded_local`` route, the same loss, gradients and
    stepped parameters within 1e-6 of each leaf's largest;
57. the all-to-all MoE (``models/moe_a2a.py``) on 8 gloo ranks that share
    the card (each a process, ``chip_smoke.py --a2a-rank``; NCCL refuses
    two ranks on one device), meshes (2, 4) and (1, 8), granite's 32
    experts top-8 at d 1024 over x [4, 32, 1024] in float32: at capacity
    factor 8.0 output and gradients within 2e-4 of max(1, each one's
    largest) of ``moe_ffn_dense_reference`` on the card, at 1.0 (tokens
    drop) of the same run with CPU tensors; the exchange's transport
    printed (gloo with CUDA tensors: through the host);
58. one NCCL rank, ``make_host_mesh("cuda")``: llsc-100m's train state
    saved and restored with ``shardings=param_shardings(...)``, every
    leaf a DTensor whose ``full_tensor()`` is the saved leaf;
59. the port's dry-run (``launch/dryrun.py probe_costs``) of phase 11's
    step, llsc-100m at 8 x 256 on a 1 x 1 mesh over a one-rank ``"fake"``
    group, in a subprocess (``chip_smoke.py --dry-run-probe``; 30 s is
    its budget): its FLOPs against 6 N D; its compute and memory terms at most
    phase 11's median step; its argument bytes exactly those of a
    ``TrainState`` and a batch built on the card; its temp + argument
    bytes against phase 11's peak, with the ratio; the roofline verdict
    of the job's published duty, step and HBM; each of 55-59 prints its
    seconds;
60. the launches of each main path (the serves of 4, 7, 19, 25, 30, 36,
    37, 39, 46, 47, 48 and 55's sampled serve, the train runs of 11, 14,
    22, 32, 40, 42, 49 and 51), one ``{"kernels": [...]}`` line (each
    kernel's launches summed over those paths), the nvidia-smi line, and
    last the ``{"ok": true, ...}`` line.

Any failed check raises, and the script exits non-zero; without a CUDA
device, or outside a checkout, it prints no result and exits 1.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import platform
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = 2e-4
# float32 training, card against CPU (phase 13): a leaf's gradients within
# GRAD_RTOL of its largest; after N AdamW steps, parameters where the
# step-1 gradient is at least UPDATE_CLEAR of its leaf's largest within
# UPDATE_RTOL * (lr_1 + ... + lr_N) plus rounding (``update_gaps``).
GRAD_RTOL = 1e-4
UPDATE_CLEAR = 1e-2
UPDATE_RTOL = 1e-2


# The flash instances of the Hopper body (D 64, 128, 256 in rows mode,
# Lb0, and split mode, Lb1), by their names in ptxas' log, with (D, split):
# none may spill.
NEW_FLASH_INSTANCES = {
    f"flash_fwd_wgmma_kernel<Li{D}ELb{int(split)}>": (D, split)
    for D in (64, 128, 256) for split in (False, True)}
# The mma.sync body at D 16 and the fp32 body at D 16 and 256, which the
# reduced configs and gemma3-1b's fp32 check run: none may spill either.
OTHER_FLASH_INSTANCES = ("flash_fwd_mma_kernel<Li16>",
                         "flash_fwd_kernel<fLi16>", "flash_fwd_kernel<fLi256>")

# The Hopper SSD body's instances (state 16 and 128, fp32 and bf16 y), by
# their names in ptxas' log, with (state, y's dtype): none may spill.
NEW_SSD_INSTANCES = {
    f"ssd_intra_chunk_wgmma_kernel<Li{n}E{o}>": (n, name)
    for n in (16, 128)
    for o, name in (("f", "float32"), ("13__nv_bfloat16", "bfloat16"))}
# The mma.sync SSD body at phase 3's three timed shapes (PERF.md, NVIDIA
# H100 80GB HBM3 at 700 W): the Hopper body must take at most 0.8x.
SSD_MMA_MS = {"serve": 0.02567, "jamba": 0.04806, "train": 0.07278}
SSD_LIMIT = 0.8
# AdamW steps of each full-width train run (phases 11, 14, 22, 32, 40, 42,
# 49 and 51): 2 of warm-up, then the steps whose median is reported.  22
# until the script neared its time limit.
TRAIN_STEPS = 8

# (H, Hk, B, S, D) of the causal bf16 flash timings in phase 3 (see
# ``phase_kernels``); ``flash_call_cost.py`` times the same shapes.
FLASH_BF16_SHAPES = ((8, 8, 4, 128, 64), (8, 8, 4, 256, 64),
                     (8, 8, 1, 128, 64), (8, 8, 8, 256, 64),
                     (16, 8, 1, 128, 128), (16, 8, 1, 256, 128),
                     (16, 8, 4, 384, 128), (16, 8, 1, 384, 128),
                     (16, 8, 1, 512, 128), (16, 8, 8, 512, 128),
                     (4, 1, 1, 64, 16), (4, 1, 1, 256, 256),
                     (4, 1, 1, 640, 256), (4, 1, 8, 256, 256),
                     (20, 20, 1, 256, 128), (40, 10, 1, 256, 128),
                     (20, 20, 8, 256, 128),
                     (64, 8, 1, 128, 128), (64, 8, 1, 256, 128),
                     (16, 8, 8, 256, 64), (16, 8, 1, 128, 64),
                     (16, 8, 1, 256, 64), (12, 12, 8, 256, 64),
                     (12, 12, 1, 128, 64), (12, 12, 1, 256, 64))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def zero_counters(counters):
    """Every launch counter to 0, the SSD wrapper's counts by body too."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    ssd = counters["ssd_intra_chunk"][0]
    ssd.launches_by_body = dict.fromkeys(ssd.BODIES, 0)


def read_counters(counters):
    """The launch counts since ``zero_counters``.  Every main path runs at
    full width, where each SSD launch (mamba2-370m's and jamba's state 128
    and 16, head dim 64) must take the Hopper body."""
    counts = {name: getattr(mod, attr) for name, (mod, attr) in
              counters.items()}
    ssd = counters["ssd_intra_chunk"][0]
    check(ssd.launches_by_body["wgmma"] == counts["ssd_intra_chunk"],
          f"SSD launches by body {ssd.launches_by_body}: not every one took "
          "the Hopper body")
    return counts


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=200, warmup=20):
    """Mean time of one call from CUDA events around ``iters`` back-to-back
    calls after ``warmup``: the device time, or the host's launch cost
    where the host cannot keep ahead of a short kernel."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_activities(prof):
    """(name, microseconds, start us, end us) of every device activity
    (kernel, copy, set) in a torch.profiler trace, leaving out the host
    operators that launch them and the device-side spans of
    ``record_function`` ranges (``labelled``), which are no work."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us(), e.time_range.start,
             e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in LABELS]


def device_ms(fn, iters=100, warmup=10, tries=8):
    """Mean device time of one call: the summed durations of the device
    activities that ``iters`` calls launch, from a torch.profiler trace of
    the device alone.  A trace in which some activity's count is not a
    whole multiple of ``iters`` has lost records, and is taken again after
    a pause that doubles each time: losses come in bursts over a few traces
    in a row (``trace_losses``).  Returns (ms, device activities per
    call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        acts = device_activities(prof)
        if not trace_losses(acts, iters):
            return sum(a[1] for a in acts) / iters / 1e3, len(acts) / iters
        pause = min(0.25 * 2 ** attempt, 4.0)
        print(f"  (the trace holds {len(acts)} device activities for "
              f"{iters} calls: records were lost; tracing again in "
              f"{pause:g} s)")
        time.sleep(pause)
    raise RuntimeError(f"chip_smoke: {tries} traces in a row lost records")


def trace_losses(acts, iters):
    """Whether a trace of ``iters`` calls has lost records: it holds none,
    or some activity name's count is not a whole multiple of ``iters``.
    Records go missing in blocks that span many calls, up to the whole
    trace (``chip_trace_probe.py``), so a count check per name also
    catches a loss that leaves the total a multiple of ``iters``."""
    counts = collections.Counter(a[0] for a in acts)
    return not counts or any(n % iters for n in counts.values())


def timed(label, fns):
    """Device ms of each of kernel, plain and library call (the keys of
    ``fns``), printed beside the event-timed cost of a call.  Without a
    library call, ``library_ms`` is None."""
    out = {"library_ms": None}
    parts = []
    for key, fn in fns.items():
        ms, n = device_ms(fn)
        out[key] = ms
        parts.append(f"{key} {ms:.5f} ms device ({n:g} launches/call, "
                     f"{cuda_ms(fn):.5f} ms a call by events)")
    print(f"  timed {label}: " + "; ".join(parts))
    return out


def compare(name, got, want, dtype_name, tol=None):
    import torch

    got, want = got.float(), want.float()
    tol = tol or ATOL[dtype_name]
    err = (got - want).abs()
    ok = bool(torch.all(err <= tol + tol * want.abs()))
    check(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    m = float(err.max())
    share, at = tol_share(err, want, tol)
    print(f"  {name}: max_abs_err {m:.3e} (atol=rtol={tol}), worst "
          f"err/(atol+rtol|want|) {share:.4f} at want {at:.4e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagrees with its plain version")
    return m


def tol_share(err, want, tol):
    """The worst err / (tol + tol |want|), and the want where it falls."""
    share = (err / (tol + tol * want.abs())).flatten()
    k = int(share.argmax())
    return float(share[k]), float(want.flatten()[k])


def raises(fn, exc, text):
    """The message of the ``exc`` that ``fn()`` raises; fails unless it
    raises one whose message holds ``text``."""
    try:
        fn()
    except exc as e:
        check(text in str(e), f"unexpected error: {e}")
        return str(e)
    raise RuntimeError(f"chip_smoke: expected {exc.__name__} ({text})")


@contextlib.contextmanager
def flash_mode(fa, mode):
    """Flash's launches with the wgmma body's mode forced to ``mode``
    ("rows" or "split") instead of the plan's rule."""
    plan = fa._plan
    fa._plan = functools.partial(plan, mode=mode)
    try:
        yield
    finally:
        fa._plan = plan


def check_refusals(torch, fa, rn, randn):
    """A bfloat16 flash input off 16-byte alignment raises; so does each of
    the five raw kernel wrappers under autograd (``kernels.ops`` routes such
    calls through its autograd Functions, phase 10); and none of them
    launches."""
    from repro_torch.kernels import ssd

    def counts():
        return (fa.launches, rn.launches, rn.gated_launches, ssd.launches)

    before = counts()
    q = randn(1, 2, 64 * 64 + 1, dtype=torch.bfloat16)[..., 1:]
    msg = raises(lambda: fa.flash_attention(*[q.view(1, 2, 64, 64)] * 3),
                 ValueError, "aligned")
    print(f"  flash bf16 at an odd element offset raises: {msg}")

    def grad(*shape):
        return randn(*shape, dtype=torch.float32).requires_grad_()

    calls = {
        "flash_attention": lambda: fa.flash_attention(
            grad(1, 2, 64, 64), randn(1, 2, 64, 64), randn(1, 2, 64, 64)),
        "flash_attention_bshd": lambda: fa.flash_attention_bshd(
            randn(1, 64, 2, 64), grad(1, 64, 2, 64), randn(1, 64, 2, 64)),
        "rmsnorm": lambda: rn.rmsnorm(randn(4, 64), grad(64)),
        "gated_rmsnorm": lambda: rn.gated_rmsnorm(
            randn(4, 64), grad(4, 64), randn(64)),
        "ssd_intra_chunk": lambda: ssd.ssd_intra_chunk(
            randn(1, 16, 2, 8), randn(1, 16, 2).abs(), -randn(2).abs(),
            grad(1, 16, 1, 4), randn(1, 16, 1, 4)),
    }
    for name, call in calls.items():
        raises(call, RuntimeError, "no backward")
    check(counts() == before, "a refused call launched a kernel")
    print(f"  raw wrappers under autograd ({', '.join(calls)}) raise; no "
          "launch")


def phase_kernels(torch, fa, rn, ref, hw):
    """Phase 3: kernels against plain versions, then timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errs = {"flash_attention": {}, "rmsnorm": {}}
    flash_cases = [  # B, H, Hk, S, D, causal: the test sweep, then llsc-100m
        (1, 2, 1, 128, 64, True), (2, 4, 2, 128, 32, True),
        (1, 4, 4, 256, 64, True), (2, 8, 2, 64, 128, True),
        (1, 2, 2, 128, 32, False), (1, 12, 12, 128, 64, True),
        (1, 12, 12, 256, 64, True), (2, 4, 2, 100, 64, True),
        (1, 12, 12, 1024, 64, True), (1, 8, 2, 320, 128, True),
        (1, 4, 2, 16, 64, True), (1, 4, 2, 1, 64, True),
        (8, 12, 12, 256, 64, True),     # a llsc-100m train step
        # granite-moe-1b-a400m (GQA, 16 query and 8 KV heads): the serve's
        # prefills and a train step
        (1, 16, 8, 128, 64, True), (1, 16, 8, 256, 64, True),
        (8, 16, 8, 256, 64, True),
        # jamba-1.5-large-398b (64 query and 8 KV heads of 128): the serve's
        # prefills
        (1, 64, 8, 128, 128, True), (1, 64, 8, 256, 128, True),
        # qwen1.5-4b (20 heads of 128) and phi3-medium-14b (40 query and 10
        # KV heads of 128): the serves' prefills and a train step
        (1, 20, 20, 128, 128, True), (1, 20, 20, 256, 128, True),
        (1, 40, 10, 128, 128, True), (1, 40, 10, 256, 128, True),
        (8, 20, 20, 256, 128, True),
        # whisper-base's decoder (8 heads of 64): the model-level serve's
        # prefills of 4 requests, the fp32 check's prefill and train step,
        # a train step
        (4, 8, 8, 128, 64, True), (4, 8, 8, 256, 64, True),
        (1, 8, 8, 128, 64, True), (1, 8, 8, 256, 64, True),
        (8, 8, 8, 256, 64, True),
        # internvl2-2b (16 query and 8 KV heads of 128): the engine's text
        # prefills of 128 and 256 tokens, the model-level prefill of 4
        # requests of 256 patches and 128 tokens, the fp32 check's prefill
        # and train step (1 x 384 and 1 x 512 positions), a train step
        (1, 16, 8, 128, 128, True), (1, 16, 8, 256, 128, True),
        (4, 16, 8, 384, 128, True), (1, 16, 8, 384, 128, True),
        (1, 16, 8, 512, 128, True), (8, 16, 8, 512, 128, True)]
    # D = 16 and 256, with T apart from S: B, H, Hk, S, T, D, causal
    flash_wide = [
        # every reduced config (reduced gemma3: 4 query heads, 1 KV head)
        (2, 4, 2, 128, 128, 16, True), (1, 4, 1, 33, 70, 16, False),
        (2, 4, 4, 100, 100, 16, True), (1, 4, 1, 64, 64, 16, True),
        # reduced whisper's prefill and train step, reduced internvl2's
        # prefill of 8 patches and 64 tokens
        (1, 4, 4, 64, 64, 16, True), (1, 4, 4, 256, 256, 16, True),
        (1, 4, 2, 72, 72, 16, True),
        # gemma3-1b's global layers: the serve's prefills, a train step,
        # the fp32 check's 1280 tokens, ragged S and T, a long causal
        (1, 4, 1, 256, 256, 256, True), (1, 4, 1, 640, 640, 256, True),
        (8, 4, 1, 256, 256, 256, True), (1, 4, 1, 1280, 1280, 256, True),
        (2, 4, 1, 100, 100, 256, True), (1, 4, 2, 33, 70, 256, False),
        (1, 4, 1, 1024, 1024, 256, True)]
    # llsc-100m's, mamba2-370m's and granite-moe-1b-a400m's rows (serve,
    # train step), jamba's (serve, on the scalar body), then widths of the
    # scalar body
    rms_cases = [(32, 128), (33, 256), (7, 64), (4, 768), (256, 768),
                 (2048, 768), (4, 1024), (256, 1024), (320, 1024),
                 (2048, 1024), (4, 8192), (256, 8192), (4, 1152),
                 (256, 1152), (640, 1152), (2048, 1152), (5, 100), (3, 101),
                 # qwen1.5-4b's and minicpm3-4b's rows (serve, train step),
                 # phi3-medium-14b's (serve, on the scalar body),
                 # minicpm3-4b's kv_norm (its q_norm is llsc-100m's 768)
                 (4, 2560), (256, 2560), (2048, 2560), (4, 5120),
                 (256, 5120), (4, 256), (256, 256), (2048, 256),
                 # whisper-base's rows of 512: a decode step, the decoder's
                 # prefills of 4 requests (128 and 256 tokens) and the
                 # encoder's, the fp32 check's decoder and encoder, a
                 # train step's decoder and encoder
                 (4, 512), (512, 512), (1024, 512), (6000, 512), (1, 512),
                 (128, 512), (1500, 512), (256, 512), (2048, 512),
                 (12000, 512),
                 # internvl2-2b's of 2048: a decode step, the engine's
                 # prefills (128 and 256 tokens), the model-level prefill
                 # of 4 x 384 positions, the fp32 check's prefill and train
                 # step (384 and 512 positions), a train step
                 (4, 2048), (128, 2048), (256, 2048), (1536, 2048),
                 (1, 2048), (384, 2048), (512, 2048), (4096, 2048)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, H, Hk, S, D, causal in flash_cases:
            q = randn(B, H, S, D, dtype=dtype)
            k, v = randn(B, Hk, S, D, dtype=dtype), randn(B, Hk, S, D, dtype=dtype)
            key = (dn, B, H, S, D, causal)
            errs["flash_attention"][key] = compare(
                f"flash {dn} B{B} H{H} Hk{Hk} S{S} D{D} causal={causal}",
                fa.flash_attention(q, k, v, causal=causal),
                ref.attention_ref(q, k, v, causal=causal), dn)
        for B, H, Hk, S, T, D, causal in flash_wide:
            q = randn(B, H, S, D, dtype=dtype)
            k, v = (randn(B, Hk, T, D, dtype=dtype) for _ in range(2))
            errs["flash_attention"][(dn, B, H, S, D, causal)] = compare(
                f"flash {dn} B{B} H{H} Hk{Hk} S{S} T{T} D{D} "
                f"causal={causal}", fa.flash_attention(q, k, v, causal=causal),
                ref.attention_ref(q, k, v, causal=causal), dn)
        # the model's layout, with q, k, v as strided views of one buffer
        qkv = randn(1, 256, 3, 12, 64, dtype=dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2)).transpose(1, 2)
        compare(f"flash_bshd {dn} B1 S256 H12 D64 seq-stride "
                f"{q.stride(1)}", fa.flash_attention_bshd(q, k, v), want, dn)
        for rows, d in rms_cases:
            x = randn(rows, d, dtype=dtype)
            s = (randn(d, dtype=torch.float32) * 0.1 + 1.0).to(dtype)
            errs["rmsnorm"][(dn, rows, d)] = compare(
                f"rmsnorm {dn} rows{rows} D{d}", rn.rmsnorm(x, s),
                ref.rmsnorm_ref(x, s), dn)
        # minicpm3-4b's kv_norm input: the first 256 of 288 columns, rows
        # 288 elements apart (the vector body), and 289 (the scalar body)
        for nrows, width in ((4, 288), (256, 288), (2048, 288), (4, 289)):
            x = randn(nrows, width, dtype=dtype)[:, :256]
            s = (randn(256, dtype=torch.float32) * 0.1 + 1.0).to(dtype)
            errs["rmsnorm"][(dn, nrows, 256, width)] = compare(
                f"rmsnorm {dn} rows{nrows} D256 of rows {width} apart",
                rn.rmsnorm(x, s), ref.rmsnorm_ref(x, s), dn)
        # rows one element off 16-byte alignment take the scalar body
        x = randn(4 * 768 + 1, dtype=dtype)[1:].view(4, 768)
        s = (randn(768, dtype=torch.float32) * 0.1 + 1.0).to(dtype)
        compare(f"rmsnorm {dn} rows4 D768 at an odd element offset",
                rn.rmsnorm(x, s), ref.rmsnorm_ref(x, s), dn)
    # bf16 x with a float32 scale, as the reference's cast_params leaves a
    # 1-D scale; the vector body, then the scalar one (odd offset)
    for rows, d, off in ((4, 768, 0), (320, 2048, 0), (4, 768, 1)):
        x = randn(rows * d + off, dtype=torch.bfloat16)[off:].view(rows, d)
        s = randn(d) * 0.1 + 1.0
        compare(f"rmsnorm bfloat16 rows{rows} D{d} float32 scale, element "
                f"offset {off}", rn.rmsnorm(x, s), ref.rmsnorm_ref(x, s),
                "bfloat16")
    check_refusals(torch, fa, rn, randn)

    # Timings at the main paths' shapes, bf16: the attention of whisper-base's
    # decoder (8 heads of 64) at the model-level serve's prefills of 4
    # requests (128 and 256 tokens), at one request's 128 and a train step,
    # of internvl2-2b's (16 query and 8 KV heads of 128) at the engine's
    # prefills of 128 and 256 tokens, the model-level prefill of 4 x 384
    # positions, one request's 384, 512 positions and a train step, of reduced
    # gemma3's prefill of 64 tokens (D 16), of gemma3-1b's global layers (4
    # query heads, 1 KV head of 256) at its prefills of 256 and 640 tokens
    # and a train step, of qwen1.5-4b's (20 heads of 128) and
    # phi3-medium-14b's (40 query, 10 KV heads of 128) prefills of 256
    # tokens and qwen's train step, of jamba's, llsc-100m's and
    # granite-moe-1b-a400m's prefills of 128 and 256 tokens and of a train
    # step (8 x 256), and a norm over a decode step's 4 slots beside a
    # prefill's rows and a train step's 2048, at gemma3's width (1152),
    # jamba's (8192), mamba2-370m's and granite's (1024), qwen1.5's and
    # minicpm3's (2560), phi3's (5120), minicpm3's kv_norm (256 of rows
    # 288 apart), whisper-base's (512: a decode step and the encoder of 4
    # requests), internvl2-2b's (2048: a decode step and a prefill) and
    # llsc-100m's and minicpm3's q_norm (768), the scale in
    # bf16 as the serves hold it.  The kernels line keeps llsc-100m's B =
    # 1, S = 256 and 4 rows of 768.
    F = torch.nn.functional
    rows = []
    bf16 = torch.bfloat16
    sms = fa._sm_count(0)
    other_s, others = 0.0, 0
    for H, Hk, B, S, D in FLASH_BF16_SHAPES:
        q = randn(B, S, H, D, dtype=bf16)
        k, v = (randn(B, S, Hk, D, dtype=bf16) for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        n_bytes = 2 * B * S * (H + Hk) * D * 2     # q, k, v read, o written
        flops = 4 * B * H * D * (S * (S + 1) // 2)  # unmasked (i, j <= i)
        bound, by = hw.bound_s(n_bytes, flops, bf16)
        t = timed(f"flash bf16 B{B} S{S} H{H} Hk{Hk} D{D} causal (library: "
                  "sdpa)",
                  dict(ms=lambda: fa.flash_attention_bshd(q, k, v),
                       plain_ms=lambda: ref.attention_ref(qt, kt, vt),
                       library_ms=lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, is_causal=True, enable_gqa=H != Hk)))
        plan = fa._plan(B, H, Hk, S, S, D, bf16, sms)
        print(f"  bound {bound * 1e3:.6f} ms ({by}: {n_bytes} B, {flops} "
              f"FLOP); plan {plan.mode} ({plan.block_m} rows x "
              f"{plan.block_n} keys, {plan.stages} stages, grid "
              f"{plan.grid}): {flops / t['ms'] / 1e9:.1f} TFLOP/s, "
              f"{bound * 1e3 / t['ms']:.4f} of the bound, "
              f"{t['ms'] / t['library_ms']:.3f}x SDPA's time")
        tiles = B * H * -(-S // 128)
        if plan.mode in ("rows", "split") and sms // 2 < tiles <= 2 * sms:
            # near the rule, its other mode checked and timed beside it
            t0 = time.perf_counter()
            other = "split" if plan.mode == "rows" else "rows"
            with flash_mode(fa, other):
                compare(f"flash bf16 B{B} S{S} H{H} Hk{Hk} D{D} in {other} "
                        "mode", fa.flash_attention_bshd(q, k, v),
                        ref.attention_ref(qt, kt, vt).transpose(1, 2),
                        "bfloat16")
                ms, _ = device_ms(lambda: fa.flash_attention_bshd(q, k, v))
            print(f"  {other} mode instead ({tiles} work tiles): {ms:.5f} "
                  f"ms device, {t['ms'] / ms:.3f} of it in {plan.mode} mode")
            other_s += time.perf_counter() - t0
            others += 1
    print(f"  the other mode at {others} shapes took {other_s:.1f} s")
    rows.append(dict(name="flash_attention", route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:27",
                     max_abs_err=errs["flash_attention"][
                         ("bfloat16", 1, 12, 256, 64, True)],
                     bound_ms=bound * 1e3, bound_by=by, **t))
    # then qwen1.5-4b's and minicpm3-4b's width (2560), phi3-medium-14b's
    # (5120), and minicpm3-4b's kv_norm (256, on rows 288 apart) and q_norm
    # (768, with llsc-100m's)
    for d, nrows_list, width in ((512, (6000, 1024, 512, 4), 512),
                                 (2048, (1536, 384, 256, 128, 4), 2048),
                                 (1152, (2048, 640, 256, 4), 1152),
                                 (8192, (256, 4), 8192),
                                 (1024, (2048, 320, 4), 1024),
                                 (2560, (2048, 256, 4), 2560),
                                 (5120, (256, 4), 5120),
                                 (256, (2048, 256, 4), 288),
                                 (768, (2048, 256, 4), 768)):
        for nrows in nrows_list:
            x = randn(nrows, width, dtype=bf16)[:, :d]
            s = (randn(d, dtype=torch.float32) * 0.1 + 1.0).to(bf16)
            n_bytes = 2 * nrows * d * 2 + d * 2
            bound, by = hw.bound_s(n_bytes, 4 * nrows * d, bf16)
            t = timed(f"rmsnorm bf16 rows{nrows} D{d}"
                      + (f" of rows {width} apart" if width != d else "")
                      + " (library: F.rms_norm)",
                      dict(ms=lambda: rn.rmsnorm(x, s),
                           plain_ms=lambda: ref.rmsnorm_ref(x, s),
                           library_ms=lambda: F.rms_norm(x, (d,), s, 1e-5)))
            print(f"  bound {bound * 1e3:.6f} ms ({by}: {n_bytes} B)")
    rows.append(dict(name="rmsnorm", route="cuda",
                     source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                     replaces="src/repro/kernels/rmsnorm.py:19",
                     max_abs_err=errs["rmsnorm"][("bfloat16", 4, 768)],
                     bound_ms=bound * 1e3, bound_by=by, **t))
    return rows


def phase_mamba_kernels(torch, rn, ssd, ref, hw):
    """Phase 3, Mamba-2 part: the gated norm and the SSD block against their
    plain versions, then timings.  No single PyTorch call computes either
    function, so neither has a library time."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    F = torch.nn.functional
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ssd_inputs(N, l, h, p, g, n, dtype):
        return (randn(N, l, h, p, dtype=dtype), F.softplus(randn(N, l, h)),
                -torch.exp(randn(h) * 0.3), randn(N, l, g, n, dtype=dtype),
                randn(N, l, g, n, dtype=dtype))

    errs = {}
    # the test sweep, jamba's decode (4 slots) and prefill rows of 16384
    # (the vector body at 32 and 16 warps a row in fp32 and bf16) and a
    # wide row of no whole number of vectors (the scalar body at 1024
    # threads a row), then mamba2-370m's decode and prefill rows
    gated_cases = [(dtype, shape) for dtype in (torch.float32, bf16)
                   for shape in ((4, 16, 128), (33, 256), (4, 16384),
                                 (256, 16384), (3, 9999))]
    gated_cases += [(bf16, (4, 2048)), (bf16, (320, 2048)),
                    (bf16, (2048, 2048))]     # a mamba2-370m train step
    for dtype, shape in gated_cases:
        dn = str(dtype).split(".")[1]
        y, z = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
        s = (randn(shape[-1]) * 0.1 + 1.0).to(dtype)
        errs[("gated", dn, shape)] = compare(
            f"gated_rmsnorm {dn} {shape}", rn.gated_rmsnorm(y, z, s),
            ref.gated_rmsnorm_ref(y, z, s), dn)
    # the models' gates: strided slices of the input projection, whose rows
    # are 2 d_inner + 2 g n + h elements apart (mamba2-370m's 4384, jamba's
    # 33056), in bf16 and, for jamba, fp32
    for dtype, rows, d, width in ((bf16, 320, 2048, 2 * 2048 + 2 * 128 + 32),
                                  (bf16, 256, 16384, 2 * 16384 + 2 * 16 + 256),
                                  (torch.float32, 256, 16384,
                                   2 * 16384 + 2 * 16 + 256)):
        dn = str(dtype).split(".")[1]
        proj = randn(rows, width, dtype=dtype)
        y = randn(rows, d, dtype=dtype)
        s = (randn(d) * 0.1 + 1.0).to(dtype)
        errs[("gated strided", dn, d)] = compare(
            f"gated_rmsnorm {dn} ({rows}, {d}) gate row-stride "
            f"{proj.stride(0)}", rn.gated_rmsnorm(y, proj[:, :d], s),
            ref.gated_rmsnorm_ref(y, proj[:, :d], s), dn)
    # rows one element off 16-byte alignment take the scalar body
    for dtype in (torch.float32, bf16):
        dn = str(dtype).split(".")[1]
        for d in (2048, 16384):
            y = randn(4 * d + 1, dtype=dtype)[1:].view(4, d)
            z = randn(4, d, dtype=dtype)
            s = (randn(d) * 0.1 + 1.0).to(dtype)
            compare(f"gated_rmsnorm {dn} (4, {d}), y at an odd element "
                    "offset", rn.gated_rmsnorm(y, z, s),
                    ref.gated_rmsnorm_ref(y, z, s), dn)
    # bf16 y, z with a float32 scale: vector body, then scalar body
    for rows, d, off in ((4, 2048, 0), (320, 2048, 0), (4, 2048, 1),
                         (4, 16384, 0), (256, 16384, 0), (4, 16384, 1)):
        y = randn(rows * d + off, dtype=bf16)[off:].view(rows, d)
        z = randn(rows, d, dtype=bf16)
        s = randn(d) * 0.1 + 1.0
        compare(f"gated_rmsnorm bfloat16 ({rows}, {d}) float32 scale, "
                f"element offset {off}", rn.gated_rmsnorm(y, z, s),
                ref.gated_rmsnorm_ref(y, z, s), "bfloat16")
    raises(lambda: rn.gated_rmsnorm(*[randn(2, 16385)] * 2, randn(16385)),
           ValueError, "at most 16384")
    # the test sweep (N, l, h, p, g, n), ragged chunks (40: one key tile;
    # 200 and 100: several, the last partial), p = 128, an odd number of
    # heads a group (3: one head a block), jamba's chunk of 256 (256 heads
    # of 64, state 16), then full width: the two 256-token chunks of a
    # 320-token mamba2-370m prefill; each with the (body, heads a block) it
    # takes in bf16 (in fp32 every case takes the CUDA-core body)
    ssd_sweep = (((1, 32, 4, 16, 1, 8), ("mma", 2)),
                 ((2, 64, 8, 32, 2, 16), ("mma", 2)),
                 ((1, 16, 2, 8, 2, 4), ("fp32", 0)),
                 ((3, 40, 4, 64, 1, 128), ("wgmma", 1)),
                 ((1, 200, 4, 128, 1, 64), ("mma", 2)),
                 ((2, 100, 6, 64, 2, 128), ("wgmma", 1)),
                 ((1, 256, 256, 64, 1, 16), ("wgmma", 1)))
    ssd_cases = [(dtype, case, body if dtype == bf16 else ("fp32", 0))
                 for dtype in (torch.float32, bf16)
                 for case, body in ssd_sweep]
    ssd_cases.append((bf16, (2, 256, 32, 64, 1, 128), ("wgmma", 1)))
    for dtype, case, want in ssd_cases:
        dn = str(dtype).split(".")[1]
        x, dt_, A, B, C = ssd_inputs(*case, dtype)
        plan = ssd.plan(*case, dtype)
        check((plan.body, plan.heads_per_block) == want,
              f"ssd {dn} {case}: planned {plan}, not {want}")
        # fp32 y within SSD_TOL; a bf16 input's bf16 y within bf16's 2e-2
        for out in {torch.float32, dtype}:
            on = str(out).split(".")[1]
            got = ssd.ssd_intra_chunk(x, dt_, A, B, C, out_dtype=out)
            err = compare(
                f"ssd_intra_chunk {dn} in, {on} out, N,l,h,p,g,n={case} "
                f"({ssd_body(ssd)})", got,
                ref.ssd_intra_chunk_ref(x, dt_, A, B, C, out_dtype=out), on,
                tol=SSD_TOL if out == torch.float32 else None)
            if out == torch.float32:
                errs[("ssd", dn, case)] = err
            check((ssd.body, ssd.heads_per_block) == want,
                  f"ssd {dn} {case}: took {ssd_body(ssd)}, not {want}")
    ssd_numerics(torch, ssd, ref)
    cumsum_order(torch, ref)
    x, dt_, A, B, C = ssd_inputs(2, 256, 32, 64, 1, 128, bf16)
    compare("ssd_intra_chunk bfloat16 in and out, full width",
            ssd.ssd_intra_chunk(x, dt_, A, B, C),
            ref.ssd_intra_chunk_ref(x, dt_, A, B, C), "bfloat16")
    check(ssd.body == "wgmma", f"full width took {ssd_body(ssd)}")

    rows = []
    # jamba's 256-token prefill and decode step (rows of 16384); then
    # mamba2-370m's train step's 8 x 256 rows, a 320-token prefill and a
    # decode step's slots; the scale in bf16, as the serves hold it
    for d, nrows in ((16384, 256), (16384, 4), (2048, 2048), (2048, 320),
                     (2048, 4)):
        y, z = randn(nrows, d, dtype=bf16), randn(nrows, d, dtype=bf16)
        s = (randn(d) * 0.1 + 1.0).to(bf16)
        n_bytes = 3 * nrows * d * 2 + d * 2
        flops = 8 * nrows * d     # silu (exp, add, div), *y, h*h, +, *r, *s
        bound, by = hw.bound_s(n_bytes, flops, bf16)
        t = timed(f"gated_rmsnorm bf16 rows{nrows} D{d} (no library call)",
                  dict(ms=lambda: rn.gated_rmsnorm(y, z, s),
                       plain_ms=lambda: ref.gated_rmsnorm_ref(y, z, s)))
        print(f"  bound {bound * 1e3:.6f} ms ({by}: {n_bytes} B, {flops} FLOP)")
    rows.append(dict(name="gated_rmsnorm", route="cuda",
                     source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                     replaces="src/repro/kernels/rmsnorm.py:26",
                     max_abs_err=errs[("gated", "bfloat16", (4, 2048))],
                     bound_ms=bound * 1e3, bound_by=by, **t))

    def ssd_bound(N, l, h, p, g, n):
        n_bytes = (N * l * h * p * 2 + N * l * h * 4 + h * 4
                   + 2 * N * l * g * n * 2
                   + N * l * h * p * 4)       # x, dt, A, B, C in; fp32 y out
        pairs = l * (l + 1) // 2              # causal (i, j <= i) pairs
        flops = N * (g * pairs * 2 * n         # C_i . B_j per group
                     + h * pairs * (2 * p + 3)  # decay, weight, W @ xdt
                     + l * h * (p + 2))        # x * dt, dt * A, cumsum
        return n_bytes, flops, *hw.bound_s(n_bytes, flops, bf16)

    def ssd_timed(x, dt_, A, B, C, label, shape, bound):
        """Times the kernel and its plain version at a main path's shape;
        the Hopper body must take it, in at most SSD_LIMIT of the mma.sync
        body's time."""
        ssd.ssd_intra_chunk(x, dt_, A, B, C, out_dtype=torch.float32)
        check(ssd.body == "wgmma", f"{label}: took {ssd_body(ssd)}")
        t = timed(f"{label}, {ssd_body(ssd)} (no library call)", dict(
            ms=lambda: ssd.ssd_intra_chunk(x, dt_, A, B, C,
                                           out_dtype=torch.float32),
            plain_ms=lambda: ref.ssd_intra_chunk_ref(
                x, dt_, A, B, C, out_dtype=torch.float32)))
        old = SSD_MMA_MS[shape]
        print(f"  {shape}: {t['ms'] / old:.3f}x the mma.sync body's {old} ms "
              f"(target 0.5x, limit {SSD_LIMIT}x); "
              f"{t['ms'] / (bound * 1e3):.2f}x the byte bound")
        check(t["ms"] <= SSD_LIMIT * old, f"{label}: {t['ms']:.5f} ms, over "
              f"{SSD_LIMIT} of the mma.sync body's {old} ms")
        return t

    def ssd_bf16_out(x, dt_, A, B, C, label):
        compare(f"{label}, bfloat16 out", ssd.ssd_intra_chunk(x, dt_, A, B, C),
                ref.ssd_intra_chunk_ref(x, dt_, A, B, C), "bfloat16")
        check(ssd.body == "wgmma", f"{label}: took {ssd_body(ssd)}")

    # jamba's prefill chunk of 256 tokens (256 heads of 64, state 16), as
    # the model hands it over: x, B, C views of one conv output (row stride
    # 16416; B at 16384, C at 16400, 16-byte aligned: the tensor-core body)
    case = (1, 256, 256, 64, 1, 16)
    N, l, h, p, g, n = case
    xbc = randn(N, l, h * p + 2 * g * n, dtype=bf16)
    jx = (xbc[..., :h * p].unflatten(-1, (h, p)), F.softplus(randn(N, l, h)),
          -torch.exp(randn(h) * 0.3),
          xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n)),
          xbc[..., h * p + g * n:].unflatten(-1, (g, n)))
    got = ssd.ssd_intra_chunk(*jx, out_dtype=torch.float32)
    check(ssd.body == "wgmma", f"jamba's views took {ssd_body(ssd)}, not "
          "the Hopper body")
    label = (f"ssd_intra_chunk bf16 in, N,l,h,p,g,n={case}, x/B/C views of "
             f"one buffer (row stride {xbc.stride(1)})")
    errs[("ssd jamba views",)] = compare(
        f"{label}, fp32 out ({ssd_body(ssd)})", got,
        ref.ssd_intra_chunk_ref(*jx, out_dtype=torch.float32), "float32",
        tol=SSD_TOL)
    ssd_bf16_out(*jx, label)
    n_bytes, flops, bound, by = ssd_bound(*case)
    ssd_timed(*jx, f"ssd_intra_chunk bf16 in, fp32 out, N{N} l{l} h{h} p{p} "
              f"g{g} n{n} (jamba's prefill chunk, the model's views)",
              "jamba", bound)
    print(f"  bound {bound * 1e3:.6f} ms ({by}: {n_bytes} B, {flops} FLOP)")
    # a mamba2-370m train step: 8 sequences of one chunk of 256
    case = (8, 256, 32, 64, 1, 128)
    xs8 = ssd_inputs(*case, bf16)
    compare(f"ssd_intra_chunk bf16 in, fp32 out, N,l,h,p,g,n={case} (a train "
            f"step)", ssd.ssd_intra_chunk(*xs8, out_dtype=torch.float32),
            ref.ssd_intra_chunk_ref(*xs8, out_dtype=torch.float32),
            "float32", tol=SSD_TOL)
    check(ssd.body == "wgmma", f"the train step took {ssd_body(ssd)}")
    ssd_bf16_out(*xs8, f"ssd_intra_chunk bf16 in, N,l,h,p,g,n={case}")
    n_bytes, flops, bound, by = ssd_bound(*case)
    ssd_timed(*xs8, "ssd_intra_chunk bf16 in, fp32 out, N8 l256 h32 p64 g1 "
              "n128 (a train step)", "train", bound)
    print(f"  bound {bound * 1e3:.6f} ms ({by}: {n_bytes} B, {flops} FLOP)")
    N, l, h, p, g, n = 2, 256, 32, 64, 1, 128
    n_bytes, flops, bound, by = ssd_bound(N, l, h, p, g, n)
    t = ssd_timed(x, dt_, A, B, C, f"ssd_intra_chunk bf16 in, fp32 out, N{N} "
                  f"l{l} h{h} p{p} g{g} n{n}", "serve", bound)
    print(f"  bound {bound * 1e3:.6f} ms ({by}: {n_bytes} B, {flops} FLOP)")
    # The serve's prompts (128, 320) are padded to whole chunks, which
    # copies x, B and C: the timing above is that contiguous layout.  A
    # prompt of whole chunks hands the kernel strided views of the conv
    # output instead; checked and timed here, not in the kernels line.
    xbc = randn(N, l, h * p + 2 * g * n, dtype=bf16)
    xs = xbc[..., :h * p].unflatten(-1, (h, p))
    Bs = xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    Cs = xbc[..., h * p + g * n:].unflatten(-1, (g, n))
    label = (f"ssd_intra_chunk bf16 in, fp32 out, N{N} l{l} h{h} p{p} g{g} "
             f"n{n}, x/B/C views of one buffer (row stride {xbc.stride(1)})")
    got = ssd.ssd_intra_chunk(xs, dt_, A, Bs, Cs, out_dtype=torch.float32)
    check(ssd.body == "wgmma", f"the model's views took {ssd_body(ssd)}, "
          "not the Hopper body")
    compare(f"{label} ({ssd_body(ssd)})", got,
            ref.ssd_intra_chunk_ref(xs, dt_, A, Bs, Cs,
                                    out_dtype=torch.float32),
            "float32", tol=SSD_TOL)
    ssd_bf16_out(xs, dt_, A, Bs, Cs, label.replace(", fp32 out", ""))
    timed(label, dict(ms=lambda: ssd.ssd_intra_chunk(
        xs, dt_, A, Bs, Cs, out_dtype=torch.float32)))
    # B and C one element off 16-byte alignment take the CUDA-core body
    xbc = randn(N, l, h * p + 2 * g * n + 1, dtype=bf16)
    Bo = xbc[..., h * p + 1:h * p + g * n + 1].unflatten(-1, (g, n))
    Co = xbc[..., h * p + g * n + 1:].unflatten(-1, (g, n))
    got = ssd.ssd_intra_chunk(xs, dt_, A, Bo, Co, out_dtype=torch.float32)
    check(ssd.body == "fp32", f"unaligned B, C took {ssd_body(ssd)}, not "
          "the CUDA-core body")
    compare(f"ssd_intra_chunk bf16 in, fp32 out, full width, B/C at an odd "
            f"element offset ({ssd_body(ssd)})", got,
            ref.ssd_intra_chunk_ref(xs, dt_, A, Bo, Co,
                                    out_dtype=torch.float32),
            "float32", tol=SSD_TOL)
    rows.append(dict(name="ssd_intra_chunk", route="cuda",
                     source="src/repro_torch/kernels/csrc/ssd.cu",
                     replaces="src/repro/kernels/ssd.py:27",
                     max_abs_err=errs[("ssd", "bfloat16", (N, l, h, p, g, n))],
                     bound_ms=bound * 1e3, bound_by=by, **t))
    return rows


def ssd_numerics(torch, ssd, ref):
    """The SSD block at full width on the draw of the CPU emulation of its
    tensor-core arithmetic (numpy seed 17, in the order of
    tests/test_torch_kernels.py::_ssd_tensor_core_emulation): the kernel,
    the plain version on the card and the plain version on the CPU, each
    against float64 on the CPU (from the same fp32 cumsums), as shares of
    SSD_TOL; then the kernel against each plain version.  The emulation's
    share is taken against the CPU's plain version."""
    import numpy as np

    F = torch.nn.functional
    N, l, h, p, g, n = 2, 256, 32, 64, 1, 128
    rng = np.random.default_rng(17)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    x = draw(N, l, h, p)
    dt = F.softplus(draw(N, l, h))
    A = -torch.exp(draw(h) * 0.3)
    B, C = draw(N, l, g, n), draw(N, l, g, n)
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    cs = ref.cumsum_f32((dt * A).transpose(1, 2), -1).double()   # [N,h,l]
    idx = torch.arange(l)
    decay = torch.where(idx[:, None] >= idx[None, :],
                        cs[..., :, None] - cs[..., None, :],
                        torch.full((), -float("inf"), dtype=torch.float64))
    cb = torch.einsum("cign,cjgn->cgij", C.double(), B.double())
    w = (cb.repeat_interleave(h // g, dim=1) * torch.exp(decay)
         * dt.double().transpose(1, 2)[:, :, None, :])            # [N,h,i,j]
    exact = (w @ x.double().transpose(1, 2)).transpose(1, 2)      # [N,l,h,p]
    dev = [t.cuda() for t in (x, dt, A, B, C)]
    kernel = ssd.ssd_intra_chunk(*dev, out_dtype=torch.float32).cpu()
    check(ssd.body == "wgmma", "the emulation's draw missed the Hopper body")
    plain = {"card": ref.ssd_intra_chunk_ref(*dev, out_dtype=torch.float32)
             .cpu(),
             "CPU": ref.ssd_intra_chunk_ref(x, dt, A, B, C,
                                            out_dtype=torch.float32)}
    print("  ssd_intra_chunk full width on the CPU emulation's draw "
          "(numpy seed 17), worst err/(atol+rtol|want|) at SSD_TOL:")
    for name, y in (("kernel", kernel), ("card plain", plain["card"]),
                    ("CPU plain", plain["CPU"])):
        share, at = tol_share((y.double() - exact).abs(), exact, SSD_TOL)
        print(f"    {name} vs float64: {share:.4f} at want {at:.4e}")
    for where, want in plain.items():
        compare(f"  kernel vs {where} plain", kernel, want, "float32",
                tol=SSD_TOL)


def cumsum_order(torch, ref):
    """``ref.cumsum_f32`` on the card sums left to right in float32, bit for
    bit as a loop of float32 adds and as the CPU's numpy accumulate, at the
    mamba serve's A_cum shape ([b, nc, l, g, hg], along l; two chunks of
    mamba2-370m, padded prefill) and the SSD block's [N, h, l] (along l).
    The SSD kernel and its plain version agree bit for bit on these sums
    only while this holds."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape, dim in (((2, 2, 256, 1, 32), 2), ((2, 32, 256), 2)):
        x = -F.softplus(torch.randn(shape, generator=gen, device="cuda"))
        got = ref.cumsum_f32(x, dim)
        acc, sums = torch.zeros_like(x.select(dim, 0)), []
        for i in range(x.shape[dim]):
            acc = acc + x.select(dim, i)
            sums.append(acc)
        loop = torch.stack(sums, dim)
        cpu = ref.cumsum_f32(x.cpu(), dim)
        diff = int((got != loop).sum())
        print(f"  cumsum_f32 {list(shape)} along {dim}: {diff} sums differ "
              f"from a float32 loop, {int((got.cpu() != cpu).sum())} from "
              f"the CPU's")
        check(diff == 0 and torch.equal(got.cpu(), cpu),
              f"the card's cumsum_f32 {list(shape)} does not sum left to "
              f"right in float32")


def ssd_body(ssd):
    """Which body of the SSD kernel the last launch took."""
    return {"wgmma": "the Hopper body (TMA, wgmma)",
            "mma": f"mma.sync, {ssd.heads_per_block} heads a block",
            "fp32": "CUDA cores"}[ssd.body]


def make_requests(engine_mod, vocab, n, seed, lens, new=32):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [engine_mod.Request(i, rng.integers(0, vocab, lens[i % len(lens)])
                               .astype(np.int32), max_new_tokens=new)
            for i in range(n)]


def phase_serve(torch, cfg, params, engine, counters, perf, *, lens, max_seq,
                profile=False, parts=None, requests=8, new=32, ecfg=None):
    """Phases 4, 7, 19, 25, 30, 36, 37, 39 and 47 (6, 9, 21, 26, 31 and 38 with
    ``profile``, the functions of ``parts``, (module, {label: attribute})
    pairs, under their labels; by default a MoE model's ``MOE_PARTS``):
    serve ``requests`` requests (8) of the prompt lengths ``lens``, ``new``
    new tokens each (32), through 4 slots (``ecfg``: more fields of the
    ``EngineConfig``, as phase 55's sampling), with every launch counter
    of ``counters`` (name -> (module, attribute)) set to 0 just before.
    A profile with no part labelled traces the device alone: tracing the
    host's operators as well slows the host it measures and takes minutes
    to read."""
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        slots=4, max_seq_len=max_seq, job_name=f"chip_smoke:{cfg.name}",
        **(ecfg or {})))
    for r in make_requests(engine, cfg.vocab_size, requests, seed=1,
                           lens=lens, new=new):
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    with perf.perf_flags(perf.PerfFlags(flash_kernel=True)):
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx

            from repro_torch.models import moe

            if parts is None:
                parts = [(moe, MOE_PARTS)] if cfg.moe else []
            with contextlib.ExitStack() as stack:
                for module, labels in parts:
                    stack.enter_context(labelled(module, labels))
                prof = stack.enter_context(prof_ctx(
                    activities=[ProfilerActivity.CUDA]
                    + [ProfilerActivity.CPU] * bool(parts)))
                stats = eng.run()
                torch.cuda.synchronize()
            return eng, stats, prof
        stats = eng.run()
    torch.cuda.synchronize()
    counts = read_counters(counters)
    return eng, stats, counts


def report_serve(torch, np, eng, stats, counts, expect, cfg, registry):
    """Print the serve's numbers and check its launch counts and
    completions."""
    n_pre, n_dec = len(eng.prefill_s), stats["steps"]
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"{stats['requests']} requests, {stats['tokens']} tokens in "
          f"{stats['wall_s'] * 1e3:.1f} ms: {stats['tokens_per_s']:.1f} "
          f"tokens/s")
    lens = sorted({c.prompt_len for c in eng.completions})
    print(f"prefill: {n_pre} x {np.mean(eng.prefill_s) * 1e3:.3f} ms mean "
          f"({'/'.join(map(str, lens))}-token prompts, first token "
          f"included); decode: {n_dec} steps x "
          f"{np.mean(eng.decode_s) * 1e3:.3f} ms mean, "
          f"{np.median(eng.decode_s) * 1e3:.3f} ms median (4 slots)")
    print(f"peak memory allocated: {peak_mb:.1f} MiB")
    print(f"launches on the main path: {counts} (expected {expect})")
    check(counts == expect, f"launch counts {counts} != {expect}")
    check(stats["requests"] == 8, "not every request completed")
    for c in eng.completions:
        check(len(c.tokens) == 32 and all(0 <= t < cfg.vocab_size
                                          for t in c.tokens),
              f"request {c.request_id}: bad completion")
    pub = registry.entries()[f"chip_smoke:{cfg.name}"]
    check(0 < pub.duty_cycle <= 1, f"published duty {pub.duty_cycle}")
    d = stats["decision"]
    print(f"LLload registry: duty {pub.duty_cycle:.6f} of the H100 "
          f"{cfg.dtype} peak, step {pub.step_time_s * 1e3:.3f} ms, device "
          f"memory {pub.hbm_used_gb:.3f} / {pub.hbm_total_gb:.3f} GB; overload "
          f"controller: slots 4 -> {d.nppn} ({d.reason})")


def grow_time(torch, t, part, n):
    """Cache leaf ``t`` of ``part`` ("blocks", with the period axis in
    front, or "rem") with ``n`` zero positions more on its time axis, the
    one after the batch axis."""
    axis = 2 if part == "blocks" else 1
    shape = list(t.shape)
    shape[axis] = n
    return torch.cat([t, t.new_zeros(shape)], dim=axis)


def grow_caches(torch, cache, time_axis, n):
    """``cache`` with ``n`` zero positions more on the time axis of its
    ``time_axis`` leaves (self-attention's ``k`` and ``v``; an
    encoder-decoder model's ``xk`` and ``xv`` span the frames and stay)."""
    return {part: {key: {name: grow_time(torch, t, part, n)
                         if name in time_axis else t
                         for name, t in e.items()}
                   for key, e in entries.items()}
            for part, entries in cache.items()}


# Leaves the reference initializes to a constant, by their last key: the
# QKV biases (zeros) and the norm scales (ones).
BIASES = ("bq", "bk", "bv")
NORM_SCALES = ("scale", "q_norm", "kv_norm")


def plant(torch, params, seed=7):
    """``params`` (CPU tensors) with every QKV bias drawn from N(0, 0.5^2)
    and every norm scale from 1 + N(0, 0.3^2), from a CPU generator of
    ``seed``: the reference's zeros and ones would let a missing bias add
    or norm scale pass a card-against-CPU check unseen."""
    gen = torch.Generator().manual_seed(seed)

    def walk(tree):
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                out[key] = walk(leaf)
            elif key in BIASES + NORM_SCALES:
                noise = torch.randn(leaf.shape, generator=gen)
                base, std = (0.0, 0.5) if key in BIASES else (1.0, 0.3)
                out[key] = (base + std * noise).to(leaf.dtype)
            else:
                out[key] = leaf
        return out

    return walk(params)


def patches(cfg):
    """P, the patches a ``patch_stub`` model puts before the tokens; 0
    otherwise (an encoder's frames take no decoder position)."""
    return cfg.frontend_len if cfg.frontend == "patch_stub" else 0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def card_vs_cpu(torch, np, model_lib, perf, time_axis, cfg, S,
                scalar_norm=False, banded=False, planted=False):
    """Phases 5, 8, 20, 27, 28, 34, 35, 44, 45, 53 and 54: float32 logits
    of one seed's weights on the card and on the CPU over an S-token
    prefill and 8 greedy decode steps, each side choosing its own tokens,
    with ``flash_kernel`` on and ``banded_local`` as ``banded`` says; with
    ``planted``, the biases and norm scales drawn by ``plant``.  A model
    with a stub frontend takes the same standard-normal frames or patches
    on both sides (``SyntheticLM.frontend``'s CPU draw), and decodes from
    P + S.  With ``scalar_norm`` the card runs once more with every
    RMSNorm input copied one element off 16-byte alignment, so that the
    norm takes its scalar body instead of the vector one."""
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.train.data import DataConfig, SyntheticLM

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p_cpu = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu", dtype=torch.float32)
    if planted:
        p_cpu = plant(torch, p_cpu)

    fe_cpu = SyntheticLM(DataConfig(cfg.vocab_size, S, 1, 0)).frontend(
        0, cfg32)

    def run(dev):
        p = _to(p_cpu, dev) if dev == "cuda" else p_cpu
        tokens = torch.as_tensor(
            np.random.default_rng(2).integers(0, cfg.vocab_size, (1, S)),
            device=dev)
        fe = None if fe_cpu is None else fe_cpu.to(dev)
        start = S + patches(cfg)
        logits_all = []
        with perf.perf_flags(perf.PerfFlags(flash_kernel=True,
                                            banded_local=banded)):
            logits, cache = model_lib.prefill(p, cfg32, tokens, fe)
            # room for 8 more tokens on the time axis of attention caches
            cache = grow_caches(torch, cache, time_axis, 8)
            for step in range(9):
                logits_all.append(logits.cpu())
                if step == 8:
                    break
                tok = torch.argmax(logits, dim=-1)
                logits, cache = model_lib.decode_step(p, cfg32, tok[:, None],
                                                      cache, start + step)
        return logits_all

    def compare(card, cpu, quiet=False):
        worst, all_same = 0.0, True
        for i, (a, b) in enumerate(zip(card, cpu)):
            err = float((a - b).abs().max())
            same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
            worst, all_same = max(worst, err), all_same and same
            if not quiet:
                print(f"  {'prefill' if i == 0 else f'decode {i}'}: max |card "
                      f"- cpu| {err:.3e}, same greedy token: {same}")
            check(torch.isfinite(a).all().item(), "non-finite logits on the "
                  "card")
            check(same, "the card and the CPU chose different tokens")
        check(worst <= 1e-4, f"card vs CPU logits differ by {worst:.3e} > "
              "1e-4")
        return worst, all_same

    cpu = run("cpu")
    worst, _ = compare(run("cuda"), cpu)
    print(f"  worst {worst:.3e} (tol 1e-4)")
    if not scalar_norm:
        return
    vector_body = rn.rmsnorm

    def off_alignment(x, scale, eps=1e-5):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        x_off = buf[1:].view(x.shape)
        x_off.copy_(x)
        return vector_body(x_off, scale, eps)

    rn.rmsnorm = off_alignment
    try:
        worst_s, _ = compare(run("cuda"), cpu, quiet=True)
    finally:
        rn.rmsnorm = vector_body
    print(f"  every RMSNorm on its scalar body: worst {worst_s:.3e}; on the "
          f"vector body (above): {worst:.3e}")


# The hand-written kernels, by their names in a trace.
KERNEL_NAMES = {"flash_attention": re.compile(r"flash_fwd"),
                "rmsnorm": re.compile(r"(?<!\w)rmsnorm_(vec_)?kernel"),
                "gated_rmsnorm": re.compile(r"gated_rmsnorm_(vec_)?kernel"),
                "ssd_intra_chunk": re.compile(
                    r"ssd_intra_chunk_(mma_|wgmma_)?kernel")}


def kernels_under(evt):
    """(name, us) of the kernels a profiler host event and its children
    launched."""
    out = [(k.name, k.duration) for k in evt.kernels]
    for child in evt.cpu_children:
        out += kernels_under(child)
    return out


def device_ms_under(prof, match):
    """Device ms of the kernels launched under every host event whose name
    ``match`` accepts, its children included."""
    return sum(us for e in prof.events() if match(e.name)
               for _, us in kernels_under(e)) / 1e3


# The MoE's parts (models/moe.py), by label: each function runs under a
# torch.profiler.record_function range of its label while ``labelled``
# holds.  "MoE, all" covers the others and the router's logits.
MOE_PARTS = {"MoE, all": "moe_ffn", "route (top-k, softmax)": "_route",
             "sort (positions)": "_positions", "scatter (dispatch)":
             "_dispatch", "expert products": "_experts",
             "combine": "_combine"}


# A dense model's parts, by label: attention in ``models/attention.py``
# (GQA's or MLA's prefill and decode) and the FFN in
# ``models/transformer.py``.  Phase 38 profiles phi3-medium-14b's serve
# with them.
GQA_PARTS = {"attention (prefill)": "gqa_attention",
             "attention (decode)": "gqa_decode"}
MLA_PARTS = {"MLA (prefill)": "mla_attention", "MLA (decode)": "mla_decode"}
FFN_PARTS = {"FFN (MLP)": "mlp"}
LABELS = set(MOE_PARTS) | set(GQA_PARTS) | set(MLA_PARTS) | set(FFN_PARTS)


def dense_parts(cfg):
    """The (module, parts) pairs that label a dense model's parts."""
    from repro_torch.models import attention, transformer

    return [(attention, MLA_PARTS if cfg.mla else GQA_PARTS),
            (transformer, FFN_PARTS)]


@contextlib.contextmanager
def labelled(module, parts):
    """Each function of ``module`` named in ``parts`` (label -> attribute)
    wrapped in a ``record_function`` range of its label, while the context
    holds."""
    from torch.profiler import record_function

    saved = {attr: getattr(module, attr) for attr in parts.values()}

    def wrap(label, fn):
        def call(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return call

    for label, attr in parts.items():
        setattr(module, attr, wrap(label, saved[attr]))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(module, attr, fn)


def report_parts(prof, parts, total_ms):
    """Print the device ms under each label of ``parts`` and its share of
    ``total_ms``."""
    for label in parts:
        ms = device_ms_under(prof, lambda name: name == label)
        print(f"  {label}: {ms:.3f} ms device, {100 * ms / total_ms:.2f}% "
              "of the device time")


# New tokens a request of a labelled profile (phases 21 and 38): reading a
# trace of the host's operators takes about 1.5 s a decode step.  4, not
# 8, since phase 59 came (the script's time limit).
PROFILE_NEW = 4


def profile_first_wave(torch, cfg, params, engine, counters, perf, serve,
                       kernels, parts):
    """Phases 21 and 38: the first 4 of a serve's 8 requests (one wave
    through the 4 slots), each cut to ``PROFILE_NEW`` new tokens (a prefill
    and 3 decode steps), untraced, then under torch.profiler with the
    functions of ``parts`` labelled, reported as ``report_profile`` does:
    labels need the host's operators in the trace, and a trace of both
    takes minutes to read at some 3,000 device activities a pass."""
    _, untraced, _ = phase_serve(torch, cfg, params, engine, counters, perf,
                                 requests=4, new=PROFILE_NEW, **serve)
    report_profile(*phase_serve(torch, cfg, params, engine, counters, perf,
                                profile=True, parts=parts, requests=4,
                                new=PROFILE_NEW, **serve), untraced["wall_s"],
                   "the 4-request serve", kernels,
                   [label for _, labels in parts for label in labels])


def profile_wave(torch, cfg, params, engine, counters, perf, serve,
                 kernels, parts=()):
    """Phases 6, 9, 26 and 31: the first 4 of a serve's 8 requests (one
    wave through the 4 slots, 32 new tokens each), untraced, then under
    torch.profiler (the device only, or with a MoE model's parts labelled),
    reported as ``report_profile`` does.  Reading a trace takes some 0.3 s
    a decode step, so the whole serve's trace took 11-31 s a phase."""
    _, untraced, _ = phase_serve(torch, cfg, params, engine, counters, perf,
                                 requests=4, **serve)
    report_profile(*phase_serve(torch, cfg, params, engine, counters, perf,
                                profile=True, requests=4, **serve),
                   untraced["wall_s"], "the 4-request serve", kernels, parts)


def report_profile(eng_p, stats_p, prof, serve_wall, untraced, kernels,
                   parts=()):
    """Phases 6, 9, 21, 26 and 31: busy share of the traced serve, the
    device totals of ``kernels`` (names of ``KERNEL_NAMES``) and of the
    ``record_function`` labels ``parts``, and its largest kernels."""
    acts = device_activities(prof)
    check(acts, "the traced serve recorded no device activity")
    per_kernel = {}
    for name, us, _, _ in acts:
        per_kernel[name] = per_kernel.get(name, 0.0) + us
    busy_ms = sum(per_kernel.values()) / 1e3
    span_ms = (max(e for *_, e in acts) - min(s for *_, s, _ in acts)) / 1e3
    print(f"device activity {busy_ms:.3f} ms over {stats_p['steps']} decode "
          f"steps and {len(eng_p.prefill_s)} prefills, within {span_ms:.3f} "
          f"ms from the first device activity to the last (both from this "
          f"trace): {100 * busy_ms / span_ms:.2f}% busy, "
          f"{100 - 100 * busy_ms / span_ms:.2f}% idle; traced wall "
          f"{stats_p['wall_s'] * 1e3:.1f} ms against {untraced}'s untraced "
          f"{serve_wall * 1e3:.1f} ms")
    for label in kernels:
        mine = [us for name, us, _, _ in acts
                if KERNEL_NAMES[label].search(name)]
        print(f"  {label}: {sum(mine) / 1e3:.3f} ms device in {len(mine)} "
              f"launches, {100 * sum(mine) / 1e3 / busy_ms:.2f}% of the "
              "device time")
    report_parts(prof, parts, busy_ms)
    for key, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3:9.3f} ms  {key[:100]}")


def phase_grads(torch, ops, ref, counters):
    """Phase 10: each of the five ``kernels.ops`` entry points on the card
    with inputs that require grad, in float32 and bfloat16 at a main path's
    shapes (the norms' scale float32 with bfloat16 input, and dt and A
    float32, as training gives them).  The call goes through the entry's
    autograd Function and launches its kernel exactly once; the backward
    (the plain version's vector-Jacobian product) launches none.  The
    output and every input's gradient, in that input's dtype, agree with
    the plain route's within the kernel's tolerance of phase 3 (that of the
    call's dtype, SSD_TOL for float32 SSD).  The loss is sum(w * out) with
    w a fixed random tensor, so both routes take the same upstream
    gradient: the Function's backward is the plain version's vector-Jacobian
    product at the saved inputs (as the reference's ``custom_vjp``), so its
    gradients must come out as the plain route's.  A loss whose gradient
    depends on the output would measure how the forward's bf16 rounding
    propagates through the softmax backward instead (2-7x the bf16
    tolerance at elements near 0 with identical backwards, simulated on the
    CPU), which is no property of a route."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    F = torch.nn.functional

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def entries(dt):
        f32 = torch.float32
        return {
            "flash_attention": (ref.attention_ref, [
                randn(2, 4, 128, 64, dtype=dt), randn(2, 2, 128, 64, dtype=dt),
                randn(2, 2, 128, 64, dtype=dt)], {"causal": True}),
            "flash_attention_bshd": (ops._attention_bshd_ref, [
                randn(2, 256, 12, 64, dtype=dt) for _ in range(3)],
                {"causal": True}),
            "rmsnorm": (ref.rmsnorm_ref, [
                randn(8, 256, 768, dtype=dt),
                (randn(768, dtype=f32, scale=0.1) + 1.0)], {"eps": 1e-5}),
            "gated_rmsnorm": (ref.gated_rmsnorm_ref, [
                randn(320, 2048, dtype=dt), randn(320, 2048, dtype=dt),
                (randn(2048, dtype=f32, scale=0.1) + 1.0)], {"eps": 1e-5}),
            "ssd_intra_chunk": (ref.ssd_intra_chunk_ref, [
                randn(2, 256, 32, 64, dtype=dt),
                F.softplus(randn(2, 256, 32, dtype=f32)),
                -torch.exp(randn(32, dtype=f32, scale=0.3)),
                randn(2, 256, 1, 128, dtype=dt),
                randn(2, 256, 1, 128, dtype=dt)],
                {"out_dtype": torch.float32}),
        }

    # entry point -> (its launch counter, its autograd Function)
    route = {"flash_attention": ("flash_attention", "FlashAttention"),
             "flash_attention_bshd": ("flash_attention", "FlashAttentionBSHD"),
             "rmsnorm": ("rmsnorm", "RMSNorm"),
             "gated_rmsnorm": ("gated_rmsnorm", "GatedRMSNorm"),
             "ssd_intra_chunk": ("ssd_intra_chunk", "SSDIntraChunk")}
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        for name, (plain, inputs, kw) in entries(dt).items():
            tol = SSD_TOL if (name == "ssd_intra_chunk"
                              and dt == torch.float32) else ATOL[dn]
            mod, attr = counters[route[name][0]]
            want = plain(*inputs, **kw)
            w = randn(*want.shape, dtype=torch.float32)
            kernel_in = [x.clone().requires_grad_() for x in inputs]
            plain_in = [x.clone().requires_grad_() for x in inputs]
            before = getattr(mod, attr)
            out = getattr(ops, name)(*kernel_in, **kw)
            check(getattr(mod, attr) == before + 1, f"{name} {dn}: "
                  f"{getattr(mod, attr) - before} launches, not 1")
            check(type(out.grad_fn).__name__ == f"{route[name][1]}Backward",
                  f"{name} {dn}: the call did not go through its Function")
            (out.float() * w).sum().backward()
            (plain(*plain_in, **kw).float() * w).sum().backward()
            torch.cuda.synchronize()
            check(getattr(mod, attr) == before + 1, f"{name} {dn}: the "
                  "backward launched the kernel")
            compare(f"{name} {dn} forward", out.detach(), want, dn, tol=tol)
            for i, (a, b) in enumerate(zip(kernel_in, plain_in)):
                check(a.grad is not None and a.grad.dtype == a.dtype,
                      f"{name} {dn}: input {i} has no gradient in its dtype")
                compare(f"{name} {dn} grad of input {i} "
                        f"({str(a.dtype).split('.')[1]})", a.grad, b.grad,
                        dn, tol=tol)


def train_profile(torch, trainer, state, step, perf, kernels, backwards):
    """Phases 12, 15, 23 and 33: one train step of ``trainer`` under
    torch.profiler: its device time split into the hand-written forward
    kernels ``kernels`` (names of ``KERNEL_NAMES``; their recompute under
    remat included), the GEMMs outside the backwards of ``backwards``, the
    device time under each autograd node of ``backwards`` (label -> node
    name), and the rest; and the busy share.  For a MoE model, also the
    forward parts of ``MOE_PARTS`` (the recompute's included; their
    backwards are not under the labels)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe

    parts = MOE_PARTS if trainer.cfg.moe else {}
    batch = trainer._batch(step)
    torch.cuda.synchronize()
    with perf.perf_flags(perf.PerfFlags(flash_kernel=True)):
        with labelled(moe, parts), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            trainer.step_fn(state, batch)
            torch.cuda.synchronize()
    acts = device_activities(prof)
    check(acts, "the traced train step recorded no device activity")
    total = sum(a[1] for a in acts) / 1e3
    span = (max(a[3] for a in acts) - min(a[2] for a in acts)) / 1e3

    def named(regex, kernels):
        return sum(us for name, us in kernels if regex.search(name)) / 1e3

    gemm = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas", re.I)
    backward = {}
    for label, node in backwards.items():
        found = []
        for e in prof.events():
            if e.name.startswith("autograd::engine::evaluate_function") \
                    and e.name.endswith(node):
                found += kernels_under(e)
        backward[label] = found
    every = [(name, us) for name, us, _, _ in acts]
    shares = {f"{label} (forward kernel)": named(KERNEL_NAMES[label], every)
              for label in kernels}
    shares["GEMMs outside those backwards"] = named(gemm, every) - sum(
        named(gemm, k) for k in backward.values())
    for label, found in backward.items():
        shares[label] = sum(us for _, us in found) / 1e3
    shares["the rest"] = total - sum(shares.values())
    print(f"device activity {total:.3f} ms within {span:.3f} ms from the "
          f"first device activity to the last: {100 * total / span:.2f}% "
          f"busy, {100 - 100 * total / span:.2f}% idle")
    for label, ms in shares.items():
        print(f"  {label}: {ms:.3f} ms, {100 * ms / total:.2f}% of the "
              "device time")
    report_parts(prof, parts, total)
    per_kernel = {}
    for name, us in every:
        per_kernel[name] = per_kernel.get(name, 0.0) + us
    for key, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:9.3f} ms  {key[:100]}")


def layer_slots(cfg):
    """(mixer, mlp kind) of the layers of ``cfg``'s stacked periods, and of
    its remainder layers, in order."""
    slots = list(zip(cfg.layer_pattern, cfg.mlp_pattern))
    return slots * cfg.n_periods, slots[:cfg.n_remainder]


def block_launches(cfg, slots, *, prefill):
    """The hand-written kernels one pass over the layers ``slots`` launches
    with ``flash_kernel``: a prefill (or a train step's forward) runs flash
    for a global attention layer (the reference's gate leaves a local one,
    ``"attn_local"``, on chunked attention) and the gated norm and the SSD
    block for a Mamba-2 layer, a decode step the gated norm only (decode
    attention and the SSD recurrence are plain, as the reference's); an
    MLA layer (a config with an ``MLASpec``) runs no flash, in prefill and
    decode alike, and two more RMSNorms, ``q_norm`` and ``kv_norm``; every
    layer ln1, ln2 where it has an FFN (a MoE, or an MLP of d_ff > 0), and
    in an encoder-decoder model ``ln_x`` (its cross attention is chunked
    attention, as the reference's)."""
    out = dict.fromkeys(KERNEL_NAMES, 0)
    for kind, mlp_kind in slots:
        if kind == "ssm":
            out["gated_rmsnorm"] += 1
            out["ssd_intra_chunk"] += int(prefill)
        elif cfg.mla is not None:
            out["rmsnorm"] += 2
        elif kind == "attn":
            out["flash_attention"] += int(prefill)
        out["rmsnorm"] += 2 if mlp_kind == "moe" or cfg.d_ff > 0 else 1
        out["rmsnorm"] += int(cfg.is_encdec)
    return out


def encoder_norms(cfg):
    """The RMSNorms an encoder pass launches: ln1 and ln2 a layer and
    ``enc_norm`` (its attention is chunked, as the reference's); 0 for a
    model without an encoder."""
    return 2 * cfg.encoder.n_layers + 1 if cfg.is_encdec else 0


def serve_launches(cfg, n_pre, n_dec):
    """The launches of a serve of ``n_pre`` prefills and ``n_dec`` decode
    steps: every layer's, the final norm once a prefill or step, and the
    encoder's once a prefill."""
    layers = sum(layer_slots(cfg), [])
    pre = block_launches(cfg, layers, prefill=True)
    dec = block_launches(cfg, layers, prefill=False)
    return {k: pre[k] * n_pre + dec[k] * n_dec + (k == "rmsnorm") * (
        n_pre + n_dec + encoder_norms(cfg) * n_pre) for k in pre}


def step_launches(cfg):
    """The hand-written kernels' launches in one train step of ``cfg`` (with
    ``flash_kernel``): each block's forward kernels run once in the
    forward and, under a ``cfg.remat`` other than "none", once more in the
    backward's recompute of its period; the remainder layers, the final
    norm and the encoder lie outside the periods and run once.  The
    backwards are the plain versions'."""
    runs = 1 if cfg.remat == "none" else 2
    stacked, rem = layer_slots(cfg)
    a = block_launches(cfg, stacked, prefill=True)
    b = block_launches(cfg, rem, prefill=True)
    return {k: runs * a[k] + b[k]
            + (k == "rmsnorm") * (1 + encoder_norms(cfg)) for k in a}


def phase_train(torch, np, counters, registry, perf, smi, arch, flags=(),
                *, phase, layers=None, stats=None):
    """Phases 11-12 (llsc-100m), 14-15 (mamba2-370m), 22-23
    (granite-moe-1b-a400m), 32-33 (gemma3-1b), 40-41 (qwen1.5-4b), 42-43
    (minicpm3-4b), 49-50 (whisper-base) and 51-52 (internvl2-2b):
    ``launch.train.main`` trains ``arch`` at full width and depth
    (``layers`` of them where given: the launcher's config cut to that
    depth) in bfloat16 with float32 masters under the config's ``remat``
    ("full"), ``TRAIN_STEPS`` AdamW steps of 8 x 256 tokens (and the
    Trainer's frames or patches for a model with a stub frontend), the
    counters set to 0 just before.  Every loss is finite; each step
    launches exactly ``step_launches``; the registry holds the job's duty
    in (0, 1], from the model FLOPs of the active parameters
    (``count_params_analytic``).  Steps 3 to ``TRAIN_STEPS`` give the
    median step time and tokens/s (the first 2 are warm-up); the host-side
    init of the masters is timed apart.  Then one
    step under the profiler.  Returns the launch counts; ``stats``, where
    given, gets the median step (``median_s``), the peak memory allocated
    (``peak_bytes``) and the job's registry entry (``published``)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as model_lib
    from repro_torch.train import trainer as trainer_mod

    steps, batch, seq = TRAIN_STEPS, 8, 256
    made = []

    class Recorded(trainer_mod.Trainer):
        """The launcher's Trainer, kept with its result for the
        timings and the profile."""

        def run(self, resume=True):
            self.out = super().run(resume)
            made.append(self)
            return self.out

        def _init_state(self):
            t0 = time.perf_counter()
            state = super()._init_state()
            torch.cuda.synchronize()
            self.init_s = time.perf_counter() - t0
            return state

    launch_train.Trainer = Recorded
    get_config = launch_train.get_config
    if layers is not None:
        launch_train.get_config = lambda name: dataclasses.replace(
            get_config(name), n_layers=layers)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters(counters)
        rc = launch_train.main([
            "--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), *flags])
        torch.cuda.synchronize()
        counts = read_counters(counters)
    finally:
        launch_train.Trainer = trainer_mod.Trainer
        launch_train.get_config = get_config
    check(rc == 0 and len(made) == 1, f"launch.train exited {rc}")
    trainer = made[0]
    cfg = trainer.cfg
    losses = trainer.out["losses"]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"losses {losses}")
    per_step = step_launches(cfg)
    expect = {k: n * steps for k, n in per_step.items()}
    print(f"launches on the main path: {counts} (expected {expect}: "
          f"{per_step} a step under remat={cfg.remat!r})")
    check(counts == expect, f"launch counts {counts} != {expect}")
    pub = registry.entries()[f"train:{cfg.name}"]
    check(0 < pub.duty_cycle <= 1, f"published duty {pub.duty_cycle}")
    active = model_lib.count_params_analytic(cfg, active_only=True)
    total = model_lib.count_params(cfg)
    check(trainer._flops_per_step == 6.0 * active * batch * seq,
          "the published duty does not count the active parameters")
    print(f"duty from {active} active parameters of {total}; host-side init "
          f"of the float32 masters and moments {trainer.init_s:.1f} s (not "
          "in the step times)")
    times = np.array([h["time_s"] for h in trainer.history[2:]])
    med = float(np.median(times))
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if stats is not None:
        stats.update(median_s=med, published=dataclasses.replace(pub),
                     peak_bytes=torch.cuda.max_memory_allocated())
    print(f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, all finite")
    print(f"[{smi}] train {arch} ({cfg.n_layers} layers) bf16, {batch} x "
          f"{seq} tokens a step: "
          f"median step {med * 1e3:.3f} ms over steps 3-{steps} (min "
          f"{times.min() * 1e3:.3f}, max {times.max() * 1e3:.3f}; first two "
          f"{trainer.history[0]['time_s'] * 1e3:.1f} and "
          f"{trainer.history[1]['time_s'] * 1e3:.1f} ms); "
          f"{batch * seq / med:.1f} training tokens/s; published duty "
          f"{pub.duty_cycle:.6f} of the H100 bf16 peak (last step); peak "
          f"memory allocated {peak_mb:.1f} MiB")
    if cfg.frontend != "none":
        draw_times(torch, trainer.data, cfg)
    print(f"=== {phase + 1}. one {arch} train step under torch.profiler "
          f"[{smi}] ===")
    if cfg.family == "ssm":
        kernels = ("rmsnorm", "gated_rmsnorm", "ssd_intra_chunk")
        routes = {"ssd_intra_chunk": "SSDIntraChunk",
                  "gated_rmsnorm": "GatedRMSNorm", "rmsnorm": "RMSNorm"}
    else:
        kernels = ("flash_attention", "rmsnorm")
        routes = {"flash_attention": "FlashAttentionBSHD",
                  "rmsnorm": "RMSNorm"}
    backwards = {f"{k}'s plain-version backward": f"{fn}Backward"
                 for k, fn in routes.items()}
    # the backward of each layer's view leaf[i] of a stacked leaf: a zero
    # tensor of the whole stack with the layer's slice filled in, added
    # into the stack's gradient
    backwards["the stacked leaves' select backward"] = "SelectBackward0"
    train_profile(torch, trainer, trainer.out["state"], steps, perf, kernels,
                  backwards)
    # Recorded.run's closure holds ``made``, which holds the trainer: break
    # the cycle, so that the train state is freed on return and not by a
    # later garbage collection in another phase's memory figures
    made.clear()
    return counts


def draw_times(torch, data, cfg, reps=5):
    """Wall ms (median of ``reps``) of a train step's frames or patches
    drawn by ``SyntheticLM.frontend`` on the card, as the Trainer draws
    them, and on the host and copied to the card."""
    def wall(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[reps // 2] * 1e3

    card = wall(lambda: data.frontend(0, cfg, "cuda"))
    host = wall(lambda: data.frontend(0, cfg).to("cuda"))
    shape = tuple(data.frontend(0, cfg, "cuda").shape)
    print(f"  the step's frontend {shape} drawn on the card (the Trainer's "
          f"draw, inside the step time): {card:.3f} ms; on the host and "
          f"copied to the card: {host:.3f} ms (wall, median of {reps})")


def flat(tree, path=""):
    """{"['a']['b']": leaf} of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{path}[{key!r}]").items()}
    return {path: tree}


def grad_gaps(got, want):
    """{leaf: (max |reference gradient|, max |got - want|)} over flat dicts
    of float32 tensors on one device."""
    return {k: (float(w.abs().max()), float((got[k] - w).abs().max()))
            for k, w in want.items()}


def gap_share(peak, gap):
    """A leaf's gradient gap over its largest reference gradient.  A leaf
    the loss does not read (ln2 of a block without an FFN) has a zero
    gradient on both sides, or an infinite share."""
    if peak > 0:
        return gap / peak
    return 0.0 if gap == 0 else float("inf")


def update_gaps(got, want, g_want, lrs):
    """Parameters after ``len(lrs)`` AdamW steps of two runs from the same
    masters, ``want`` the reference's, ``g_want`` its step-1 gradients
    (flat dicts of float32 tensors on one device).  Returns the worst share
    of each of two bounds over every leaf, and the share of elements held
    to the first:

    - tight, where the reference's step-1 gradient is at least UPDATE_CLEAR
      of its leaf's largest: there Adam's update m / sqrt(v) follows the
      gradient's sign and size, so the two runs' parameters agree within
      UPDATE_RTOL * sum(lrs) plus the rounding of the stored parameters,
      half an ulp (2**-24 |p|) a side and a step.  An optimizer that does
      not step, or steps the wrong way, is off by about sum(lrs) there;
    - loose, elsewhere: gradients near 0 may give the two runs' first
      updates opposite signs, each of size up to lr_t, so within
      2 * sum(lrs) + 1e-6."""
    lr, n = sum(lrs), len(lrs)
    tight = loose = 0.0
    held = total = 0
    for k, w in want.items():
        g = g_want[k].abs()
        clear = g >= UPDATE_CLEAR * g.max()
        gap = (got[k] - w).abs()
        share = gap / (UPDATE_RTOL * lr + n * 2.0 ** -23 * w.abs())
        if clear.any():
            tight = max(tight, float(share[clear].max()))
        if not clear.all():
            loose = max(loose, float(gap[~clear].max()) / (2 * lr + 1e-6))
        held += int(clear.sum())
        total += clear.numel()
    return tight, loose, held / total


@contextlib.contextmanager
def recorded_routes():
    """While the context holds, every call of ``models.moe._route`` appends
    (logits, expert ids) on the CPU to the yielded dict's list for the
    device of its logits ("cpu" or "cuda").  On exit, prints how many
    routes (token, layer) were compared between the two lists, call by
    call, and how many of them chose other expert ids, with the gap between
    the k-th and the (k+1)-th largest CPU logit at each.  The dict's
    "flips" then holds that count."""
    from repro_torch.models import moe

    routes = {"cpu": [], "cuda": []}
    route = moe._route

    def recorded(logits, spec):
        weights, idx = route(logits, spec)
        routes[logits.device.type].append((logits.detach().cpu(),
                                           idx.cpu()))
        return weights, idx

    moe._route = recorded
    try:
        yield routes
    finally:
        moe._route = route
        n = flips = 0
        for (lc, ic), (_, ig) in zip(routes["cpu"], routes["cuda"]):
            other = (ic != ig).any(dim=-1)
            n += other.numel()
            flips += int(other.sum())
            k = ic.shape[-1]
            for top in lc[other].topk(k + 1, dim=-1).values:
                print(f"  route flip: k-th and (k+1)-th router logits "
                      f"{float(top[k - 1]):.9g}, {float(top[k]):.9g} (gap "
                      f"{float(top[k - 1] - top[k]):.3e})")
        routes["flips"] = flips
        print(f"  expert routes: {len(routes['cpu'])} router calls on the "
              f"CPU, {len(routes['cuda'])} on the card; {n} routes compared, "
              f"{flips} chose other expert ids")


@contextlib.contextmanager
def recorded_grads(ts):
    """Within the block, the gradients of every ``ts.loss_and_grads`` call
    (the train step's, so that a check of a step's gradients needs no
    forward and backward of its own) go to the list it yields."""
    seen, real = [], ts.loss_and_grads

    def recording(*args, **kwargs):
        loss, grads = real(*args, **kwargs)
        seen.append(grads)
        return loss, grads

    ts.loss_and_grads = recording
    try:
        yield seen
    finally:
        ts.loss_and_grads = real


def train_card_vs_cpu(torch, perf, cfg, aux_weights=None, banded=False,
                      planted=False):
    """Phases 13, 16, 24, 28, 34, 35, 44, 45, 53 and 54: ``cfg`` in float32
    (TF32 off), with ``planted`` the biases and norm scales drawn by
    ``plant``, under its ``remat``, the same float32 masters from one seed
    on the card and on the CPU, the same batch (1 x 256 tokens, with
    ``SyntheticLM.frontend``'s frames or patches for a model with a stub
    frontend) for 2
    ``make_train_step`` steps (with the MoE auxiliary losses at
    ``aux_weights``), with ``flash_kernel`` on and ``banded_local`` as
    ``banded`` says, and AdamW's moments in the config's
    ``opt_dtype``.  Losses within 1e-4 relative;
    step-1 gradients (those the first step computes, ``recorded_grads``)
    within 5e-3 absolute (the reference's gradient tolerance) and each
    leaf's within GRAD_RTOL of its largest; parameters after 2 steps within
    ``update_gaps``' two bounds."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import DataConfig, SyntheticLM

    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"remat {cfg.remat!r}, moments {cfg.opt_dtype}")
    ocfg = ts.default_opt_cfg(cfg, total_steps=2)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 256, 1, 0))
    batch = data.batch(0)
    fe = data.frontend(0, cfg)
    if fe is not None:
        batch["frontend"] = fe
    masters = ts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                  ocfg, device="cpu").params
    if planted:
        masters = plant(torch, masters)
    result = {}
    moment = getattr(torch, cfg.opt_dtype)
    with perf.perf_flags(perf.PerfFlags(flash_kernel=True,
                                        banded_local=banded)):
        for dev in ("cpu", "cuda"):
            t0 = time.perf_counter()
            params = _to(masters, dev)
            b = {k: v.to(dev) for k, v in batch.items()}
            state = ts.TrainState(params, opt.init_opt_state(params, ocfg))
            step_fn = ts.make_train_step(cfg, ocfg, aux_weights=aux_weights)
            losses, lrs = [], []
            with recorded_grads(ts) as seen:
                for _ in range(2):
                    state, met = step_fn(state, b)
                    losses.append(float(met["loss"]))
                    lrs.append(met["lr"])
            grads = seen[0]
            check(all(t.dtype == moment for t in flat(state.opt.m).values()),
                  f"the moments are not {cfg.opt_dtype}")
            # both sides compared on the card: the same exactly rounded
            # fp32 arithmetic as on the host, in a fraction of its time
            result[dev] = (flat(_to(grads, "cuda")), losses, lrs,
                           flat(_to(state.params, "cuda")))
            print(f"  {dev}: gradients and 2 steps in "
                  f"{time.perf_counter() - t0:.1f} s")
    (g_cpu, l_cpu, lrs, p_cpu), (g_card, l_card, _, p_card) = \
        result["cpu"], result["cuda"]

    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(l_card, l_cpu))
    gaps = grad_gaps(g_card, g_cpu)
    g_err = max(gap for _, gap in gaps.values())
    g_rel = max(gap_share(peak, gap) for peak, gap in gaps.values())
    tight, loose, held = update_gaps(p_card, p_cpu, g_cpu, lrs)
    print(f"  losses card {l_card}, CPU {l_cpu}: worst relative "
          f"{loss_rel:.3e} (tol 1e-4)")
    print("  step-1 gradients by leaf: max |CPU grad|, max |card - CPU|, "
          "their ratio")
    for k, (peak, gap) in gaps.items():
        print(f"    {k:36s} {peak:.4e} {gap:.4e} {gap_share(peak, gap):.3e}")
    print(f"  step-1 gradients: worst |card - CPU| {g_err:.3e} (tol 5e-3), "
          f"worst over leaves of |card - CPU| / max |CPU grad| {g_rel:.3e} "
          f"(tol {GRAD_RTOL:g})")
    print(f"  parameters after 2 steps (lr_1, lr_2 = {lrs[0]:.3e}, "
          f"{lrs[1]:.3e}): worst share of the tight bound {tight:.3e} on {held:.2%} of the elements (|CPU step-1 "
          f"grad| >= {UPDATE_CLEAR:g} of its leaf's max; {UPDATE_RTOL:g} "
          f"(lr_1 + lr_2) + 2 * 2^-23 |p|), of the loose bound {loose:.3e} "
          f"elsewhere (2 (lr_1 + lr_2) + 1e-6)")
    check(loss_rel <= 1e-4, "train losses differ between card and CPU")
    check(g_err <= 5e-3, "step-1 gradients differ between card and CPU")
    check(g_rel <= GRAD_RTOL, "a leaf's step-1 gradients differ between "
          "card and CPU")
    check(tight <= 1 and loose <= 1, "parameters differ between card and "
          "CPU")


def phase_remat(torch, perf, counters, smi):
    """Phase 17: one llsc-100m forward and backward (``loss_and_grads``) at
    full width and depth in bfloat16 from the same float32 masters and
    batch (8 x 256 tokens, ``flash_kernel``) under remat "none", "full" and
    "dots", each twice (none, full, dots, dots, full, none).  The loss is
    the same (the forward runs the same kernels on the same inputs);
    gradients agree with "none"'s within phase 13's bounds (5e-3, and each
    leaf's within GRAD_RTOL of its largest); launches are exactly
    ``step_launches``; peak memory under "full" is below "none"'s."""
    from repro_torch.configs import get_config
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import DataConfig, SyntheticLM

    base = get_config("llsc-100m")
    masters = ts.init_train_state(base, torch.Generator().manual_seed(0),
                                  ts.default_opt_cfg(base),
                                  device="cuda").params
    batch = SyntheticLM(DataConfig(base.vocab_size, 256, 8, 0)).batch(
        0, "cuda")
    runs = {}
    with perf.perf_flags(perf.PerfFlags(flash_kernel=True)):
        for remat in ("none", "full", "dots", "dots", "full", "none"):
            cfg = dataclasses.replace(base, remat=remat)
            zero_counters(counters)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated() / 2 ** 20
            t0 = time.perf_counter()
            loss, grads = ts.loss_and_grads(masters, cfg, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            counts = read_counters(counters)
            check(counts == step_launches(cfg), f"remat {remat}: launches "
                  f"{counts} != {step_launches(cfg)}")
            if remat in runs:
                runs[remat]["ms"].append(ms)
                continue
            runs[remat] = {"loss": float(loss), "ms": [ms], "peak": peak,
                           "before": before, "launches": counts,
                           "grads": flat(_to(grads, "cpu"))}
            del grads
    for remat, r in runs.items():
        print(f"[{smi}] remat {remat!r}: loss {r['loss']!r}, forward and "
              f"backward {r['ms'][0]:.3f} / {r['ms'][1]:.3f} ms, peak memory "
              f"allocated {r['peak']:.1f} MiB ({r['before']:.1f} MiB "
              f"allocated before it), launches {r['launches']}")
    none = runs["none"]
    for remat in ("full", "dots"):
        gaps = grad_gaps(runs[remat]["grads"], none["grads"])
        g_err = max(gap for _, gap in gaps.values())
        g_rel = max(gap_share(peak, gap) for peak, gap in gaps.values())
        same = sum(gap == 0 for _, gap in gaps.values())
        print(f"  {remat!r} against 'none': worst gradient gap {g_err:.3e} "
              f"(tol 5e-3), {g_rel:.3e} of its leaf's largest (tol "
              f"{GRAD_RTOL:g}); {same} of {len(gaps)} leaves bit for bit")
        check(runs[remat]["loss"] == none["loss"], f"remat {remat}: the "
              "loss differs from 'none''s")
        check(g_err <= 5e-3 and g_rel <= GRAD_RTOL, f"remat {remat}: the "
              "gradients differ from 'none''s")
    check(runs["full"]["peak"] < none["peak"], "peak memory under remat "
          "'full' is not below 'none''s")


def phase_checkpoint(torch, np, smi):
    """Phase 18: llsc-100m at full width and depth, bf16, 8 x 256 tokens,
    ``Trainer`` with ``ckpt_every=2`` under ``CrashInjector(5)``: the run
    raises at step 5 with checkpoints of steps 2 and 4 on disk;
    ``latest_step`` is 4; the state restored from it equals the one saved
    bit for bit; a resume starts at step 4 and ends at an uninterrupted
    run's final loss within 1e-4 relative; an async save of the final state
    writes the same files as a blocking one.  Prints the save and restore
    times and the bytes written.  The files go to build/ and are removed."""
    import json
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch.fault import CrashInjector
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.train_step import init_train_state_shape
    from repro_torch.train.trainer import Trainer, TrainerConfig

    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    cfg = get_config("llsc-100m")

    def tcfg(ckpt_dir=None):
        return TrainerConfig(steps=8, batch_size=8, seq_len=256,
                             ckpt_dir=ckpt_dir and str(ckpt_dir),
                             ckpt_every=2, log_every=0, monitor_every=0,
                             device="cuda")

    saves, saved = [], {}
    blocking_save = ck.save_checkpoint

    def recorded(ckpt_dir, step, state, extra=None, keep=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocking_save(ckpt_dir, step, state, extra, keep)
        saves.append((step, time.perf_counter() - t0))
        if step == 4:
            saved[step] = ck._flatten(state)

    try:
        whole = Trainer(cfg, tcfg()).run(resume=False)
        ck.save_checkpoint = recorded
        crashed = Trainer(cfg, tcfg(root / "run"), crash=CrashInjector(5))
        msg = raises(lambda: crashed.run(resume=False), RuntimeError,
                     "injected node failure at step 5")
        print(f"  crashed: {msg}; checkpoints "
              f"{ck.list_checkpoints(str(root / 'run'))}")
        check(ck.latest_step(str(root / "run")) == 4, "latest_step after "
              "the crash is not 4")
        template = init_train_state_shape(cfg, crashed.opt_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, meta = ck.restore_checkpoint(str(root / "run"), 4, template,
                                            device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = ck._flatten(state)
        check(got.keys() == saved[4].keys() and all(
            got[k].dtype == v.dtype and np.array_equal(got[k], v)
            for k, v in saved[4].items()), "the restored state differs from "
            "the saved one")
        resumed = Trainer(cfg, tcfg(root / "run")).run(resume=True)
    finally:
        ck.save_checkpoint = blocking_save
    rel = abs(resumed["final_loss"] - whole["final_loss"]) / abs(
        whole["final_loss"])
    print(f"  resumed at step {resumed['start_step']}: final loss "
          f"{resumed['final_loss']!r}, uninterrupted {whole['final_loss']!r} "
          f"(relative {rel:.3e}, tol 1e-4)")
    check(resumed["start_step"] == 4, "the resume did not start at step 4")
    check(rel <= 1e-4, "the resumed run's final loss differs")

    final = resumed["state"]
    t0 = time.perf_counter()
    ck.save_checkpoint_async(str(root / "async"), 8, final)
    returned_s = time.perf_counter() - t0
    ck.wait_pending_checkpoints()
    async_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.save_checkpoint(str(root / "sync"), 8, final)
    sync_s = time.perf_counter() - t0
    files = {}
    for kind in ("async", "sync"):
        path = root / kind / "step-000000008"
        with np.load(path / "arrays.npz") as zf:
            arrays = {k: zf[k] for k in zf.files}
        files[kind] = (arrays, json.loads((path / "meta.json").read_text()))
    (a, a_meta), (b, b_meta) = files["async"], files["sync"]
    check(a_meta == b_meta and a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in b),
        "the async save wrote other files than the blocking one")
    n_bytes = sum(p.stat().st_size
                  for p in (root / "sync" / "step-000000008").iterdir())
    print(f"[{smi}] checkpoint of the llsc-100m train state ({len(b)} "
          f"arrays, {n_bytes} bytes written): blocking saves "
          + ", ".join(f"step {s} {t:.3f} s" for s, t in saves)
          + f", final {sync_s:.3f} s; restore {restore_s:.3f} s; async save "
          f"returned in {returned_s * 1e3:.1f} ms, written in {async_s:.3f} "
          f"s; async and blocking files equal")
    shutil.rmtree(root, ignore_errors=True)


def phase_granite_serve(torch, np, model_lib, engine, counters, perf,
                        registry, smi):
    """Phases 19-21.  19: from the memory the earlier phases leave (printed
    after a collection and ``empty_cache``), draw granite-moe-1b-a400m's
    bf16 weights (the host-side init timed apart) and serve it as phase 4
    serves llsc-100m, with a warm-up: flash = 24 x prefills, rmsnorm = 49 x
    (prefills + decode steps), no gated norm or SSD; the engine's duty
    counts the active parameters only.  20: float32 logits of the card
    against the CPU at full width and 4 of the 24 layers over a 128-token
    prefill (capacity 40 of 128 x 8 assignments over 32 experts: tokens
    drop) and 8 greedy decode steps, tolerance 1e-4, and every layer's
    top-k expert ids the same on both sides.  21: the first 4 requests of
    19 under torch.profiler, with the MoE's parts.  Returns (the serve's launch
    counts, the config)."""
    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory allocated at the start of the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB")
    cfg = get_config("granite-moe-1b-a400m")
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cuda")
    torch.cuda.synchronize()
    print(f"host-side init of {model_lib.count_params(cfg)} bf16 parameters "
          f"(router float32): {time.perf_counter() - t0:.1f} s")
    serve = dict(lens=(128, 256), max_seq=512)
    phase_serve(torch, cfg, params, engine, counters, perf, requests=4, new=8,
                **serve)  # warm-up
    eng, stats, counts = phase_serve(torch, cfg, params, engine, counters,
                                     perf, **serve)
    expect = serve_launches(cfg, len(eng.prefill_s), stats["steps"])
    report_serve(torch, np, eng, stats, counts, expect, cfg, registry)
    active = model_lib.count_params_analytic(cfg, active_only=True)
    check(eng._flops_per_token == 2.0 * active,
          "the engine's duty does not count the active parameters")
    print(f"duty from {active} active parameters of "
          f"{model_lib.count_params(cfg)}")

    print("=== 20. card vs CPU, granite-moe-1b-a400m full width, 4 of 24 "
          "layers, float32 ===")
    with recorded_routes() as routes:
        card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES,
                    dataclasses.replace(cfg, n_layers=4), 128)
    check(routes["flips"] == 0, f"{routes['flips']} expert routes differ "
          "between the card and the CPU")

    print(f"=== 21. the first 4 requests of phase 19 under torch.profiler "
          f"[{smi}] ===")
    from repro_torch.models import moe

    profile_first_wave(torch, cfg, params, engine, counters, perf, serve,
                       ("flash_attention", "rmsnorm"), [(moe, MOE_PARTS)])
    return counts, cfg


JAMBA = "jamba-1.5-large-398b"
JAMBA_SERVE_LAYERS = 5      # slots 0-4 of the period: every kind of layer


def phase_jamba_serve(torch, np, model_lib, engine, counters, perf, hw,
                      registry, smi):
    """Phases 25-26.  25: from the memory the earlier phases leave (printed
    after a collection and ``empty_cache``), draw jamba-1.5-large-398b's
    bf16 weights at full width and 5 layers (4 Mamba-2 layers and the
    attention layer of slot 4; SwiGLU FFNs on slots 0, 2, 4 and 16-expert
    MoEs on slots 1, 3; 23,984,828,032 parameters, 7,073,394,304 active) on
    the card from a CUDA generator (the init timed apart), and serve it as
    phase 4 serves llsc-100m, with a warm-up: the launches are
    ``serve_launches``' (flash 1 a prefill, the SSD block 4 a prefill, the
    gated norm 4 and RMSNorm 11 a prefill or decode step), every request
    completes, the duty counts the active parameters.  26: the serve under
    torch.profiler, with the MoE's parts, and one decode step's device
    time against its bound: the bytes of the weights it reads (every leaf
    but the embedding table, of which it reads 4 rows) at the HBM rate.
    Returns the serve's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import leaves

    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory allocated at the start of the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB")
    cfg = dataclasses.replace(get_config(JAMBA), n_layers=JAMBA_SERVE_LAYERS)
    total = model_lib.count_params(cfg)
    active = model_lib.count_params_analytic(cfg, active_only=True)
    check((total, active) == (23_984_828_032, 7_073_394_304),
          f"jamba at 5 layers counts {total} parameters, {active} active")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"init of {total} parameters ({active} active; {cfg.n_periods} "
          f"stacked periods, {cfg.n_remainder} remainder layers) on the card "
          f"from a CUDA generator: {time.perf_counter() - t0:.1f} s, "
          f"{n_bytes} bytes, {torch.cuda.memory_allocated() / 2 ** 20:.1f} "
          "MiB allocated")
    serve = dict(lens=(128, 256), max_seq=512)
    phase_serve(torch, cfg, params, engine, counters, perf, requests=4, new=8,
                **serve)  # warm-up
    eng, stats, counts = phase_serve(torch, cfg, params, engine, counters,
                                     perf, **serve)
    expect = serve_launches(cfg, len(eng.prefill_s), stats["steps"])
    print(f"[{smi}] jamba-1.5-large-398b, {cfg.n_layers} layers, full width:")
    report_serve(torch, np, eng, stats, counts, expect, cfg, registry)
    check(eng._flops_per_token == 2.0 * active,
          "the engine's duty does not count the active parameters")
    del eng

    print(f"=== 26. the first 4 requests of phase 25 under torch.profiler "
          f"[{smi}] ===")
    profile_wave(torch, cfg, params, engine, counters, perf, serve,
                 tuple(KERNEL_NAMES), MOE_PARTS)
    decode_vs_hbm(torch, model_lib, hw, cfg, params, smi, serve["max_seq"])
    return counts


def decode_vs_hbm(torch, model_lib, hw, cfg, params, smi, max_seq):
    """Phases 26, 36-39, 46 and 47: the device time of one decode step of 4
    slots at 300 tokens (10 steps in one trace, over 10: the count of
    device activities a step varies, so ``device_ms``' check does not
    apply), against its bound: the bytes of the weights it reads (every
    leaf but the embedding table, of which it reads 4 rows, and the
    encoder's, which decode does not run) and of an encoder-decoder
    model's cross-attention keys and values ``xk``, ``xv``, at the HBM
    rate."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import leaves

    caches = model_lib.init_cache(cfg, 4, max_seq, device="cuda")
    tok = torch.zeros(4, 1, dtype=torch.int64, device="cuda")
    lens = torch.full((4,), 300, device="cuda")
    for _ in range(3):
        model_lib.decode_step(params, cfg, tok, caches, lens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            model_lib.decode_step(params, cfg, tok, caches, lens)
        torch.cuda.synchronize()
    acts = device_activities(prof)
    ms, n = sum(a[1] for a in acts) / 10 / 1e3, len(acts) / 10
    def n_bytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree))

    emb = params["embed"]
    read = n_bytes({k: v for k, v in params.items()
                    if k not in ("embed", "enc_blocks", "enc_norm")}) \
        + 4 * emb.shape[1] * emb.element_size()
    cross = sum(n_bytes(e[n]) for part in caches.values()
                for e in part.values() for n in ("xk", "xv") if n in e)
    what = "the weights it reads"
    if cross:
        read += cross
        what += f" and the encoder's keys and values ({cross} bytes)"
    print(f"[{smi}] one decode step of 4 slots: {ms:.3f} ms device in "
          f"{n:g} device activities; {what}, {read} bytes, take "
          f"{read / hw.HBM_BW * 1e3:.3f} ms at {hw.HBM_BW / 1e12:.2f} TB/s "
          f"({100 * read / hw.HBM_BW * 1e3 / ms:.1f}% of the bound)")


def attention_block_vs_cpu(torch, perf, cfg):
    """Phase 27 (b): the attention block of ``cfg``'s first attention slot
    (attention and its FFN) alone at full width in float32, on the card and
    on the CPU from the same weights and inputs: ``apply_block_full`` over
    128 tokens (flash on), then 8 ``apply_block_decode`` steps on the KV
    cache it made, each output within 1e-4."""
    from repro_torch.models import transformer as tf

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    slot = cfg.layer_pattern.index("attn")
    mlp_kind = cfg.mlp_pattern[slot]
    gen = torch.Generator().manual_seed(0)

    def make(leaf):
        out = torch.empty(leaf.shape, dtype=torch.float32)
        if leaf.std is None:
            out.copy_(leaf.fixed(leaf.shape))
        else:
            tf._draw(out, leaf.std, gen, out.numel())
        return out

    bp = tf._tree_map(make, tf._block_spec(cfg32, "attn", mlp_kind))
    S, steps = 128, 8
    draw = torch.Generator().manual_seed(1)
    x = torch.randn(1, S, cfg.d_model, generator=draw)
    xs = [torch.randn(1, 1, cfg.d_model, generator=draw)
          for _ in range(steps)]
    out = {}
    with perf.perf_flags(perf.PerfFlags(flash_kernel=True)):
        for dev in ("cpu", "cuda"):
            p = _to(bp, dev)
            y, cache, _ = tf.apply_block_full(
                p, x.to(dev), cfg32, "attn", mlp_kind,
                torch.arange(S, device=dev))
            cache = {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, steps))
                     for n, t in cache.items()}
            ys = [y.cpu()]
            for i in range(steps):
                ys.append(tf.apply_block_decode(
                    p, xs[i].to(dev), cfg32, "attn", mlp_kind, cache,
                    S + i).cpu())
            out[dev] = ys
    errs = [float((a - b).abs().max()) for a, b in zip(out["cuda"],
                                                       out["cpu"])]
    print(f"  slot {slot} (attention, {mlp_kind}): "
          f"{sum(t.numel() for t in tf.leaves(bp))} parameters; max |card - "
          f"cpu| of the block's output: prefill {errs[0]:.3e}, decode steps "
          + ", ".join(f"{e:.3e}" for e in errs[1:]) + " (tol 1e-4)")
    check(all(torch.isfinite(t).all() for t in out["cuda"]),
          "non-finite block output on the card")
    check(max(errs) <= 1e-4, "the attention block differs between card and "
          "CPU")


def phase_jamba_checks(torch, np, model_lib, engine, perf):
    """Phases 27-29.  27: float32 at full width, card against CPU within
    1e-4: (a) the whole model at 1 layer (a Mamba-2 layer and a SwiGLU FFN)
    over a 128-token prefill and 8 greedy decode steps, the same tokens;
    (b) the attention block alone (``attention_block_vs_cpu``).  28:
    reduced jamba (one period of 8, d_head 16) in float32 with
    ``flash_kernel``, card against CPU: prefill and decode logits, then 2
    train steps with bf16 moments and the MoE auxiliary losses, with no
    expert-route flip.  29: the entry
    points on the card: ``launch.serve`` and ``launch.train`` (20 steps)
    of reduced jamba exit 0."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(JAMBA)
    print("=== 27. card vs CPU, jamba-1.5-large-398b full width, float32: "
          "(a) the model at 1 layer, (b) the attention block of slot 4 ===")
    card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES,
                dataclasses.replace(cfg, n_layers=1), 128)
    attention_block_vs_cpu(torch, perf, cfg)

    print("=== 28. card vs CPU, reduced jamba-1.5-large-398b (one period of "
          "8), float32, flash_kernel (D 16): serve logits, then training "
          "with bf16 moments and aux losses (0.01, 1e-3) ===")
    small = reduced_config(cfg)
    with recorded_routes() as routes:
        card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES,
                    small, 64)
    check(routes["flips"] == 0, f"{routes['flips']} expert routes differ")
    with recorded_routes() as routes:
        train_card_vs_cpu(torch, perf, small, aux_weights=(0.01, 1e-3))
    check(routes["flips"] == 0, f"{routes['flips']} expert routes differ")

    print("=== 29. the entry points on the card: launch.serve and "
          "launch.train --arch jamba-1.5-large-398b --reduced ===")
    rc = launch_serve.main(["--arch", JAMBA, "--reduced"])
    check(rc == 0, f"launch.serve exited {rc}")
    rc = launch_train.main(["--arch", JAMBA, "--reduced", "--steps", "20"])
    check(rc == 0, f"launch.train exited {rc}")

GEMMA = "gemma3-1b"
GEMMA_CHECK_LAYERS = 6      # one period: 5 local layers and the global one


def phase_gemma_serve(torch, np, model_lib, engine, counters, perf,
                      registry, smi):
    """Phases 30-31.  30: from the memory the earlier phases leave (printed
    after a collection and ``empty_cache``), draw gemma3-1b's bf16 weights
    at full width and depth (999,812,736 parameters; 4 periods of 5
    sliding-window layers and a global one, 2 local remainder layers) on
    the card from a CUDA generator, and serve it with ``flash_kernel`` as
    phase 4 serves llsc-100m, with a warm-up: prompts of 256 and 640
    tokens (multiples of 128: the global layers take flash), 32 new tokens
    each, ``max_seq_len`` 768, so the 640-token requests decode past the
    512-token window.  The launches are ``serve_launches``': flash 4 a
    prefill (the global layers; a local layer takes chunked attention, as
    the reference's gate says), RMSNorm 53 a prefill or decode step.  31:
    the serve under torch.profiler.  Returns the serve's launch counts."""
    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory allocated at the start of the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB")
    cfg = get_config(GEMMA)
    total = model_lib.count_params(cfg)
    check(total == 999_812_736, f"gemma3-1b counts {total} parameters")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"init of {total} bf16 parameters ({cfg.n_periods} stacked "
          f"periods of {cfg.layer_pattern}, {cfg.n_remainder} remainder "
          f"layers) on the card from a CUDA generator: "
          f"{time.perf_counter() - t0:.1f} s")
    serve = dict(lens=(256, 640), max_seq=768)
    phase_serve(torch, cfg, params, engine, counters, perf, requests=4, new=8,
                **serve)  # warm-up
    eng, stats, counts = phase_serve(torch, cfg, params, engine, counters,
                                     perf, **serve)
    expect = serve_launches(cfg, len(eng.prefill_s), stats["steps"])
    print(f"[{smi}] gemma3-1b, full width and depth:")
    report_serve(torch, np, eng, stats, counts, expect, cfg, registry)
    del eng

    print(f"=== 31. the first 4 requests of phase 30 under torch.profiler "
          f"[{smi}] ===")
    profile_wave(torch, cfg, params, engine, counters, perf, serve,
                 ("flash_attention", "rmsnorm"))
    return counts


def banded_vs_cpu(torch, np, model_lib, perf, cfg, S):
    """Phase 34 (b): float32 forward of ``S`` tokens, ``flash_kernel`` on,
    on the CPU and on the card without ``banded_local`` and on the card
    with it: the hidden states after the final norm and the logits of
    every 16th position.  Card against CPU and banded against masked
    within 1e-4."""
    from repro_torch.models import transformer as tf

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p_cpu = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu", dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, S))
    out = {}
    for dev, banded in (("cpu", False), ("cuda", False), ("cuda", True)):
        p = _to(p_cpu, dev) if dev == "cuda" else p_cpu
        t0 = time.perf_counter()
        with perf.perf_flags(perf.PerfFlags(flash_kernel=True,
                                            banded_local=banded)):
            h, _ = model_lib.forward_hidden(
                p, cfg32, torch.as_tensor(tokens, device=dev))
            logits = tf._logits(p, cfg32, h[:, ::16])
        out[(dev, banded)] = (h.cpu(), logits.cpu())
        check(torch.isfinite(logits).all().item(), "non-finite logits")
        print(f"  {dev}, banded_local={banded}: {time.perf_counter() - t0:.1f}"
              " s")
        del p
    worst = 0.0
    for a, b in ((("cuda", False), ("cpu", False)),
                 (("cuda", True), ("cpu", False)),
                 (("cuda", True), ("cuda", False))):
        eh = float((out[a][0] - out[b][0]).abs().max())
        el = float((out[a][1] - out[b][1]).abs().max())
        worst = max(worst, eh, el)
        print(f"  {a} against {b}: hidden {eh:.3e}, logits {el:.3e}")
    check(worst <= 1e-4, f"the {S}-token forward differs by {worst:.3e}")


def phase_gemma_checks(torch, np, model_lib, engine, perf):
    """Phases 34-35.  34: float32 at full width and 6 of 26 layers (one
    period: 5 local layers and the global one), card against CPU within
    1e-4: (a) a 640-token prefill and 8 greedy decode steps past the
    512-token window, the same tokens; (b) a 1280-token forward with and
    without ``banded_local`` (past ``attn_chunk`` 1024, so the band
    engages); (c) 2 train steps, gradients within 1e-4 of each leaf's
    largest.  35: reduced gemma3 (7 layers, window 8, d_head 16) in float32
    with ``flash_kernel`` and ``banded_local``, card against CPU: prefill
    and decode logits, then 2 train steps; and ``launch.serve`` and
    ``launch.train`` (20 steps) of reduced gemma3 exit 0."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(GEMMA), n_layers=GEMMA_CHECK_LAYERS)
    print(f"=== 34. card vs CPU, gemma3-1b full width, {GEMMA_CHECK_LAYERS} "
          "of 26 layers, float32: (a) a 640-token prefill and 8 decode "
          "steps, (b) 1280 tokens with and without banded_local, (c) 2 "
          "train steps ===")
    card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES, cfg, 640)
    banded_vs_cpu(torch, np, model_lib, perf, cfg, 1280)
    gc.collect()
    train_card_vs_cpu(torch, perf, dataclasses.replace(cfg, dtype="float32"))

    print("=== 35. card vs CPU, reduced gemma3-1b, float32, flash_kernel (D "
          "16) and banded_local; launch.serve and launch.train --reduced ===")
    small = reduced_config(get_config(GEMMA))
    card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES, small,
                64, banded=True)
    train_card_vs_cpu(torch, perf, small, banded=True)
    flags = ["--flags", "flash_kernel,banded_local"]
    rc = launch_serve.main(["--arch", GEMMA, "--reduced", *flags])
    check(rc == 0, f"launch.serve exited {rc}")
    rc = launch_train.main(["--arch", GEMMA, "--reduced", "--steps", "20",
                            *flags])
    check(rc == 0, f"launch.train exited {rc}")


# qwen1.5-4b (QKV bias), phi3-medium-14b (40 query and 10 KV heads) and
# minicpm3-4b (MLA), with their parameter counts and the launches a
# prefill, and a prefill or decode step, makes at full depth (flash,
# RMSNorm): phases 36-45.  (QPM: qwen1.5, phi3, minicpm3.)
QPM = {"qwen1.5-4b": (3_950_369_280, 40, 81),
           "phi3-medium-14b": (14_659_507_200, 40, 81),
           "minicpm3-4b": (4_261_902_848, 0, 249)}
QPM_TRAIN_LAYERS = 8    # (flash, RMSNorm) a train step at that depth:
QPM_STEP = {"qwen1.5-4b": (16, 33), "minicpm3-4b": (0, 65)}
# whisper-base (encoder-decoder) and internvl2-2b (patch frontend): phases
# 46-54, at full width and depth.  internvl2-2b's engine serve is text only,
# as the reference's: (parameters, flash, RMSNorm) as ``QPM``'s.
WHISPER, INTERNVL2 = "whisper-base", "internvl2-2b"
ENGINE_SERVES = {**QPM, INTERNVL2: (1_889_146_880, 24, 49)}


def draw_on_card(torch, model_lib, cfg, n_params):
    """From the memory the earlier phases leave (printed after a collection
    and ``empty_cache``), ``cfg``'s bf16 weights, ``n_params`` of them,
    drawn on the card from a CUDA generator, the time printed."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory allocated at the start of the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB")
    total = model_lib.count_params(cfg)
    check(total == n_params, f"{cfg.name} counts {total} parameters")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"init of {total} bf16 parameters ({cfg.n_layers} layers) on the "
          f"card from a CUDA generator: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB allocated")
    return params


def phase_qpm_serve(torch, np, model_lib, engine, counters, perf, hw,
                    registry, smi, arch, profile_phase=None, params=None):
    """Phases 36, 37 and 39: from the memory the earlier phases leave
    (printed after a collection and ``empty_cache``), draw ``arch``'s bf16
    weights at full width and depth on the card from a CUDA generator (the
    init timed apart; phi3-medium-14b's 14,659,507,200 parameters are 29.3
    GB), and serve it with ``flash_kernel`` as phase 4 serves llsc-100m,
    after a warm-up of 2 requests (one of each prompt length): prompts of
    128 and 256 tokens (multiples of 128, so qwen's and phi3's layers take
    flash), 32 new tokens each, ``max_seq_len`` 384.  The launches are
    ``serve_launches``': flash 40 a prefill and RMSNorm 81 a prefill or
    decode step for qwen1.5 and phi3; for minicpm3 no flash (MLA takes
    chunked attention, as the reference's) and RMSNorm 249 (4 a layer:
    ln1, ln2, q_norm, kv_norm, and the final norm).  Then one decode step's
    device time against the HBM time of its weights (``decode_vs_hbm``);
    with ``profile_phase``, the first 4 requests under torch.profiler with
    attention and the FFN labelled (``profile_first_wave``, phase 38).
    Phase 47 serves internvl2-2b the same way, text only, on ``params``
    it was given (24 flash and 49 RMSNorm).  Returns the serve's launch
    counts."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    n_params, flash, norms = ENGINE_SERVES[arch]
    if params is None:
        params = draw_on_card(torch, model_lib, cfg, n_params)
    serve = dict(lens=(128, 256), max_seq=384)
    phase_serve(torch, cfg, params, engine, counters, perf, requests=2,
                **serve)  # warm-up
    eng, stats, counts = phase_serve(torch, cfg, params, engine, counters,
                                     perf, **serve)
    n_pre, n_dec = len(eng.prefill_s), stats["steps"]
    expect = serve_launches(cfg, n_pre, n_dec)
    check({k: v for k, v in expect.items() if v}
          == {k: v for k, v in (("flash_attention", flash * n_pre),
                                ("rmsnorm", norms * (n_pre + n_dec))) if v},
          f"serve_launches of {arch}: {expect}")
    print(f"[{smi}] {arch}, full width and depth:")
    report_serve(torch, np, eng, stats, counts, expect, cfg, registry)
    del eng
    decode_vs_hbm(torch, model_lib, hw, cfg, params, smi, serve["max_seq"])
    if profile_phase:
        print(f"=== {profile_phase}. the first 4 requests of {arch} under "
              f"torch.profiler [{smi}] ===")
        profile_first_wave(torch, cfg, params, engine, counters, perf, serve,
                           ("flash_attention", "rmsnorm"), dense_parts(cfg))
    del params
    return counts


def absorbed_vs_naive(torch, np, model_lib, perf, cfg, S):
    """Phase 44 (b): float32 on the card, an S-token prefill and 8 greedy
    decode steps of ``cfg`` (MLA: the decode steps run the absorbed form),
    then one naive forward over the prompt and the 8 chosen tokens: the
    logits of its positions S - 1 to S + 7 against those of the prefill
    and of each decode step, within 1e-4."""
    from repro_torch.models import transformer as tf

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p = _to(plant(torch, model_lib.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)), "cuda")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, S)), device="cuda")
    steps, chosen, stepwise = 8, [], []
    with perf.perf_flags(perf.PerfFlags(flash_kernel=True)):
        logits, cache = model_lib.prefill(p, cfg32, tokens)
        cache = {part: {key: {n: grow_time(torch, t, part, steps)
                              for n, t in e.items()}
                        for key, e in entries.items()}
                 for part, entries in cache.items()}
        for step in range(steps + 1):
            stepwise.append(logits)
            if step == steps:
                break
            chosen.append(torch.argmax(logits, dim=-1))
            logits, cache = model_lib.decode_step(
                p, cfg32, chosen[-1][:, None], cache, S + step)
        full = torch.cat([tokens, torch.stack(chosen, dim=1)], dim=1)
        h, _ = model_lib.forward_hidden(p, cfg32, full)
        naive = tf._logits(p, cfg32, h[:, S - 1:])
    errs = [float((naive[:, i] - stepwise[i]).abs().max())
            for i in range(steps + 1)]
    print(f"  {cfg.name}, {cfg.n_layers} layer(s), on the card: naive "
          f"forward over {S + steps} tokens against the prefill and the "
          f"{steps} absorbed decode steps: max |naive - stepwise| "
          + ", ".join(f"{e:.3e}" for e in errs) + " (tol 1e-4)")
    check(torch.isfinite(naive).all().item(), "non-finite naive logits")
    check(max(errs) <= 1e-4, "the absorbed decode differs from the naive "
          "attention on the card")


def phase_qpm_checks(torch, np, model_lib, engine, perf):
    """Phases 44-45.  44: float32 at full width and 1 layer (every kind of
    leaf: the stacked layer holds the biases, the MLA projections and
    norms), biases and norm scales planted (``plant``), card against CPU
    within 1e-4: (a) a 256-token prefill and 8 greedy decode steps of each
    of the three, the same tokens; (b) minicpm3-4b's absorbed decode
    against the naive attention on the card; (c) 2 train steps of
    qwen1.5-4b and minicpm3-4b, gradients within 1e-4 of each leaf's
    largest.  45: the reduced configs in float32 with ``flash_kernel`` (D
    16), planted, card against CPU: prefill and decode logits, then 2
    train steps; and ``launch.serve`` and ``launch.train`` (20 steps) of
    each, reduced, exit 0."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    gc.collect()
    torch.cuda.empty_cache()
    print("=== 44. card vs CPU at full width, 1 layer, float32, biases and "
          "norm scales planted: (a) a 256-token prefill and 8 decode steps "
          "of qwen1.5-4b, phi3-medium-14b and minicpm3-4b, (b) minicpm3-4b's "
          "absorbed decode against the naive attention, (c) 2 train steps "
          "of qwen1.5-4b and minicpm3-4b ===")
    for arch in QPM:
        card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES,
                    dataclasses.replace(get_config(arch), n_layers=1), 256,
                    planted=True)
        gc.collect()
    absorbed_vs_naive(torch, np, model_lib, perf, dataclasses.replace(
        get_config("minicpm3-4b"), n_layers=1), 256)
    for arch in QPM_STEP:
        train_card_vs_cpu(torch, perf, dataclasses.replace(
            get_config(arch), n_layers=1, dtype="float32"), planted=True)
        gc.collect()

    print("=== 45. card vs CPU, reduced qwen1.5-4b, phi3-medium-14b and "
          "minicpm3-4b, float32, flash_kernel (D 16), planted; launch.serve "
          "and launch.train --reduced ===")
    for arch in QPM:
        small = reduced_config(get_config(arch))
        card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES,
                    small, 64, planted=True)
        train_card_vs_cpu(torch, perf, small, planted=True)
        flags = ["--flags", "flash_kernel"]
        rc = launch_serve.main(["--arch", arch, "--reduced", *flags])
        check(rc == 0, f"launch.serve {arch} exited {rc}")
        rc = launch_train.main(["--arch", arch, "--reduced", "--steps", "20",
                                *flags])
        check(rc == 0, f"launch.train {arch} exited {rc}")


def phase_model_serve(torch, np, model_lib, engine, counters, perf, smi, cfg,
                      params, *, prompts=(128, 256), requests=4, new=32):
    """Phases 46 and 48: serve ``cfg`` at the model level, as the
    reference's own tests serve whisper (its engine takes no frames): for
    each prompt length of ``prompts`` a batch of ``requests`` requests,
    each with its frontend embeddings (whisper's 1500 frames, internvl2's
    256 patches) from ``SyntheticLM.frontend`` in the model dtype; a
    prefill (the encoder's pass included) gives each request's first token
    and ``new`` - 1 greedy decode steps the rest, at ``cache_len`` P + S +
    step.  After a warm-up pass, the counters are set to 0 just before and
    must read ``serve_launches`` of the prefills and decode steps.  Prints
    tokens/s, prefill and decode ms, peak memory and, with an encoder, its
    device ms for one batch alone.  Returns the launch counts."""
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import DataConfig, SyntheticLM

    rng = np.random.default_rng(1)
    batches = [(torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                             (requests, S)), device="cuda"),
                SyntheticLM(DataConfig(cfg.vocab_size, S, requests, i))
                .frontend(0, cfg, "cuda"))
               for i, S in enumerate(prompts)]

    def run():
        pre, dec, out = [], [], []
        for tokens, fe in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model_lib.prefill(params, cfg, tokens, fe)
            tok = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
            cache = grow_caches(torch, cache, engine.TIME_AXIS_LEAVES, new)
            chosen, start = [tok], patches(cfg) + tokens.shape[1]
            for step in range(new - 1):
                t0 = time.perf_counter()
                logits, cache = model_lib.decode_step(
                    params, cfg, tok[:, None], cache, start + step)
                tok = torch.argmax(logits, dim=-1)
                torch.cuda.synchronize()
                dec.append(time.perf_counter() - t0)
                chosen.append(tok)
            out.append(torch.stack(chosen, dim=1).cpu())
        return pre, dec, out

    with perf.perf_flags(perf.PerfFlags(flash_kernel=True)):
        run()   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters(counters)
        t0 = time.perf_counter()
        pre, dec, out = run()
        wall = time.perf_counter() - t0
        counts = read_counters(counters)
        expect = serve_launches(cfg, len(pre), len(dec))
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        enc_ms = None
        if cfg.is_encdec:
            fe = batches[0][1]
            enc_ms = cuda_ms(lambda: tf.encode(params, cfg, fe), iters=10,
                             warmup=2)
    n_tok = sum(o.numel() for o in out)
    front = (f"{cfg.encoder.source_len} frames" if cfg.is_encdec
             else f"{patches(cfg)} patches")
    print(f"[{smi}] {cfg.name} at the model level, {len(batches)} batches of "
          f"{requests} requests ({front} and "
          f"{'/'.join(map(str, prompts))} tokens each), {new} new tokens "
          f"each: {n_tok} tokens in {wall * 1e3:.1f} ms, "
          f"{n_tok / wall:.1f} tokens/s; prefill {np.mean(pre) * 1e3:.3f} ms "
          f"mean (first token included); decode {len(dec)} steps x "
          f"{np.mean(dec) * 1e3:.3f} ms mean, {np.median(dec) * 1e3:.3f} ms "
          f"median ({requests} rows); peak memory allocated {peak_mb:.1f} MiB"
          + (f"; the encoder alone over {requests} x "
             f"{cfg.encoder.source_len} frames {enc_ms:.3f} ms (CUDA events)"
             if enc_ms is not None else ""))
    print(f"launches on the main path: {counts} (expected {expect})")
    check(counts == expect, f"launch counts {counts} != {expect}")
    check(all(o.shape == (requests, new) and int(o.min()) >= 0
              and int(o.max()) < cfg.vocab_size for o in out),
          "bad completions")
    return counts


def phase_whisper_internvl2(torch, np, model_lib, engine, counters, perf, hw,
                            registry, smi, by_path):
    """Phases 46-52: whisper-base served at the model level (46) and
    internvl2-2b through ``ServeEngine``, text only (47), and at the model
    level with its patches (48), at full width and depth with their bf16
    weights drawn on the card; each decode step's device time against the
    HBM time of what it reads; then both trained at full width and depth
    through ``launch.train.main`` (49-52), each batch with its frames or
    patches.  Adds each path's launch counts to ``by_path``."""
    from repro_torch.configs import get_config

    print(f"=== 46. serve {WHISPER} at the model level, full width and "
          f"depth, bf16, flash_kernel: 2 batches of 4 requests of 1500 "
          f"frames and 128 / 256 tokens [{smi}] ===")
    cfg = get_config(WHISPER)
    params = draw_on_card(torch, model_lib, cfg, 97_166_336)
    by_path[f"serve {WHISPER} (model level)"] = phase_model_serve(
        torch, np, model_lib, engine, counters, perf, smi, cfg, params)
    decode_vs_hbm(torch, model_lib, hw, cfg, params, smi, 512)
    del params

    print(f"=== 47. serve {INTERNVL2}, full width and depth, bf16, "
          f"flash_kernel, through ServeEngine (text only) [{smi}] ===")
    cfg = get_config(INTERNVL2)
    params = draw_on_card(torch, model_lib, cfg, ENGINE_SERVES[INTERNVL2][0])
    by_path[f"serve {INTERNVL2}"] = phase_qpm_serve(
        torch, np, model_lib, engine, counters, perf, hw, registry, smi,
        INTERNVL2, params=params)
    print(f"=== 48. serve {INTERNVL2} at the model level: 4 requests of 256 "
          f"patches and 128 tokens [{smi}] ===")
    by_path[f"serve {INTERNVL2} (model level, patches)"] = phase_model_serve(
        torch, np, model_lib, engine, counters, perf, smi, cfg, params,
        prompts=(128,))
    del params

    for phase, arch, front in ((49, WHISPER, "8 x 1500 frames"),
                               (51, INTERNVL2, "8 x 256 patches")):
        print(f"=== {phase}. train {arch}, full width and depth, bf16, "
              f"flash_kernel, remat 'full', {front} a step, through "
              f"launch.train [{smi}] ===")
        gc.collect()
        torch.cuda.empty_cache()
        by_path[f"train {arch}"] = phase_train(
            torch, np, counters, registry, perf, smi, arch,
            ("--flags", "flash_kernel"), phase=phase)


def phase_whisper_internvl2_checks(torch, np, model_lib, engine, perf):
    """Phases 53-54.  53: float32, norm scales planted (``plant``), card
    against CPU within 1e-4: whisper-base at full width and depth (a
    prefill of 1500 frames and 128 tokens and 8 greedy decode steps; 2
    train steps, the encoder's gradients among the leaves) and
    internvl2-2b at full width and 1 layer with 256 patches, the same.
    54: reduced whisper and internvl2 in float32 with ``flash_kernel`` (D
    16), planted, card against CPU: prefill and decode logits, then 2
    train steps; ``launch.train`` (20 steps) of each exits 0, as does
    ``launch.serve`` of internvl2; ``launch.serve`` of whisper exits 1 with
    the port's message (its engine takes no frames, as the reference's)."""
    import io

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    gc.collect()
    torch.cuda.empty_cache()
    print(f"=== 53. card vs CPU, float32, norm scales planted: {WHISPER} at "
          f"full width and depth (1500 frames, 128 tokens), {INTERNVL2} at "
          "full width and 1 layer (256 patches, 128 tokens): prefill, 8 "
          "decode steps, 2 train steps ===")
    for cfg in (get_config(WHISPER),
                dataclasses.replace(get_config(INTERNVL2), n_layers=1)):
        card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES, cfg,
                    128, planted=True)
        train_card_vs_cpu(torch, perf, dataclasses.replace(
            cfg, dtype="float32"), planted=True)
        gc.collect()

    print(f"=== 54. card vs CPU, reduced {WHISPER} and {INTERNVL2}, float32, "
          "flash_kernel (D 16), planted; launch.train and launch.serve "
          "--reduced ===")
    flags = ["--flags", "flash_kernel"]
    for arch in (WHISPER, INTERNVL2):
        small = reduced_config(get_config(arch))
        card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES,
                    small, 64, planted=True)
        train_card_vs_cpu(torch, perf, small, planted=True)
        rc = launch_train.main(["--arch", arch, "--reduced", "--steps", "20",
                                *flags])
        check(rc == 0, f"launch.train {arch} exited {rc}")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = launch_serve.main(["--arch", arch, "--reduced", *flags])
        if arch == WHISPER:
            check(rc == 1 and "needs frames" in err.getvalue(),
                  f"launch.serve {arch} exited {rc}: {err.getvalue()}")
            print(f"  launch.serve {arch} exits 1: "
                  f"{err.getvalue().strip()}")
        else:
            check(rc == 0, f"launch.serve {arch} exited {rc}: "
                  f"{err.getvalue()}")


# --------------------------------------------------------------------------
# Phases 55-58: sampling, banded=, the all-to-all MoE, sharded restore
# --------------------------------------------------------------------------

SAMPLING = dict(greedy=False, temperature=0.8, top_k=40, seed=0)


def completions(eng):
    return {c.request_id: c.tokens for c in eng.completions}


def phase_sampling(torch, np, model_lib, engine, counters, perf, registry,
                   smi):
    """Phase 55: serve llsc-100m at full width and depth in bfloat16 with
    ``flash_kernel`` as phase 4, greedy and with ``SAMPLING`` (temperature
    0.8, top 40, seed 0), in turns: greedy, sampled, ``top_k=1``, greedy,
    sampled (after a warm-up of 4 requests of 8 tokens); each serve's
    launches are counted from 0 and must read exactly ``serve_launches``,
    the first sampled serve's being the main path's; two sampled serves
    give the same tokens, as two greedy ones do, ``top_k=1`` greedy's, and
    the sampled ones differ from greedy's; the draws come from a CUDA
    generator; then at the model level a 128-token prefill of 4 rows and 8
    decode steps, each row's token drawn by the engine's ``_select`` and in
    the top 40 of its logits.  Returns the sampled serve's launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import model_dtype

    cfg = get_config("llsc-100m")
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cuda")
    serve = dict(lens=(128, 256), max_seq=512)
    phase_serve(torch, cfg, params, engine, counters, perf, requests=4, new=8,
                **serve)  # warm-up
    runs = {}
    # in turns: greedy and sampled twice each, the host's pace drifting
    for name, ecfg in (("greedy", {}), ("sampled", SAMPLING),
                       ("top_k=1", {**SAMPLING, "top_k": 1}),
                       ("greedy again", {}),
                       ("sampled again", SAMPLING)):
        eng, stats, counts = phase_serve(torch, cfg, params, engine,
                                         counters, perf, ecfg=ecfg, **serve)
        expect = serve_launches(cfg, len(eng.prefill_s), stats["steps"])
        check(counts == expect, f"{name}: launches {counts} != {expect}")
        runs[name] = (eng, stats, counts)
        print(f"  {name}: {stats['tokens_per_s']:.1f} tokens/s, decode "
              f"{np.median(eng.decode_s) * 1e3:.3f} ms a step median "
              f"({np.mean(eng.decode_s) * 1e3:.3f} mean), prefill "
              f"{np.mean(eng.prefill_s) * 1e3:.3f} ms mean [{smi}]")
    eng, stats, counts = runs["sampled"]
    report_serve(torch, np, eng, stats, counts,
                 serve_launches(cfg, len(eng.prefill_s), stats["steps"]),
                 cfg, registry)
    tokens = {name: completions(run[0]) for name, run in runs.items()}
    check(tokens["sampled"] == tokens["sampled again"],
          "two sampled serves of one seed differ")
    check(tokens["greedy"] == tokens["greedy again"],
          "two greedy serves differ")
    check(tokens["top_k=1"] == tokens["greedy"],
          "top_k=1 does not give greedy's tokens")
    check(tokens["sampled"] != tokens["greedy"],
          "the sampled serve gave greedy's tokens")
    same = sum(a == b for r in tokens["greedy"] for a, b in
               zip(tokens["greedy"][r], tokens["sampled"][r]))
    pace = {kind: [np.median(runs[n][0].decode_s) * 1e3 for n in
                   (kind, kind + " again")] for kind in ("greedy", "sampled")}
    print(f"  sampled against greedy: {same} of {stats['tokens']} tokens "
          "the same; two sampled serves and top_k=1 against greedy: "
          f"identical; decode ms a step median, greedy "
          f"{pace['greedy'][0]:.3f} / {pace['greedy'][1]:.3f}, sampled "
          f"{pace['sampled'][0]:.3f} / {pace['sampled'][1]:.3f}")
    gen = eng.sample_generator(0)
    check(gen.device.type == "cuda", f"the draws come from a generator on "
          f"{gen.device}")

    S, rows, top_k = 128, 4, SAMPLING["top_k"]
    tokens_in = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (rows, S)), device="cuda")
    inside = 0
    with torch.no_grad(), perf.perf_flags(perf.PerfFlags(flash_kernel=True)):
        logits, caches = model_lib.prefill(params, cfg, tokens_in)
        caches = grow_caches(torch, caches, engine.TIME_AXIS_LEAVES, 8)
        for step in range(8):
            tok = eng._select(logits, step)
            top = torch.topk(logits, top_k, dim=-1).indices
            inside += int((top == tok[:, None]).any(dim=1).sum())
            logits, caches = model_lib.decode_step(
                params, cfg, tok[:, None].to(tokens_in.dtype), caches,
                S + step)
    check(inside == 8 * rows, f"{8 * rows - inside} sampled tokens outside "
          f"the top {top_k}")
    print(f"  model level ({model_dtype(cfg)}): {inside} of {8 * rows} "
          f"tokens drawn in the top {top_k} of their logits; generator on "
          f"{gen.device}")
    del params, eng, runs
    return counts


def phase_banded(torch, perf):
    """Phase 56: reduced gemma3-1b (7 layers, window 8, ``attn_chunk``
    16) in float32 on the card with ``flash_kernel``, 2 x 64 tokens:
    ``make_train_step(banded=True)`` and ``loss_and_grads(banded=True)``
    against the ``banded_local`` route: the same loss, and gradients and
    the stepped parameters within 1e-6 of each leaf's largest."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as model_lib
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = reduced_config(get_config(GEMMA))
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cuda", dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen)
    batch = {"tokens": tokens[:, :-1].cuda(), "labels": tokens[:, 1:].cuda()}
    ocfg = ts.default_opt_cfg(cfg, total_steps=2)
    state = ts.TrainState(params, opt.init_opt_state(params, ocfg))
    out = {}
    for name, banded, flags in (
            ("banded=True", True, perf.PerfFlags(flash_kernel=True)),
            ("banded_local", False, perf.PerfFlags(flash_kernel=True,
                                                   banded_local=True))):
        with perf.perf_flags(flags):
            loss, grads = ts.loss_and_grads(params, cfg, batch, banded=banded)
            new, met = ts.make_train_step(cfg, ocfg, banded=banded)(state,
                                                                    batch)
        out[name] = (float(loss), float(met["loss"]), flat(grads),
                     flat(new.params))
    (l1, m1, g1, p1), (l2, m2, g2, p2) = out.values()
    check(abs(l1 - l2) <= 1e-6 * abs(l2) and abs(m1 - m2) <= 1e-6 * abs(m2),
          f"losses {l1}, {m1} against {l2}, {m2}")
    worst = 0.0
    for got, want in ((g1, g2), (p1, p2)):
        for key, (peak, gap) in grad_gaps(got, want).items():
            worst = max(worst, gap_share(peak, gap))
    check(worst <= 1e-6, f"banded=True against banded_local: {worst:.3e} of "
          "a leaf's largest")
    print(f"  loss {l1:.6f} (banded=True) and {l2:.6f} (banded_local); "
          f"gradients and one step's parameters within {worst:.3e} of each "
          "leaf's largest")


# The all-to-all MoE on the card (phase 57): granite-moe-1b-a400m's experts
# (32, top 8, d_ff 512) at its d_model of 1024, x [4, 32, 1024] float32.
A2A_WORLD = 8
A2A_MESHES = ((2, 4), (1, 8))
A2A_SHAPE = (4, 32, 1024)
# Outputs and gradients within A2A_TOL of max(1, each one's largest): a
# gradient summed over 128 tokens of 1024-wide rows runs to hundreds, and
# the dense oracle and the ranks sum it in other orders.
A2A_TOL = 2e-4


def a2a_inputs(torch):
    """(spec, params, x) on the CPU, from seed 0."""
    import math

    from repro_torch.configs import get_config

    spec = dataclasses.replace(get_config("granite-moe-1b-a400m").moe,
                               capacity_factor=8.0)
    d, E, f = A2A_SHAPE[-1], spec.n_experts, spec.d_ff_expert
    gen = torch.Generator().manual_seed(0)
    params = {"router": torch.randn(d, E, generator=gen) / math.sqrt(d),
              "w1": torch.randn(E, d, f, generator=gen) / math.sqrt(d),
              "w3": torch.randn(E, d, f, generator=gen) / math.sqrt(d),
              "w2": torch.randn(E, f, d, generator=gen) / math.sqrt(f)}
    return spec, params, torch.randn(A2A_SHAPE, generator=gen)


def a2a_rank(rank, world, store, out):
    """One gloo rank of phase 57 (``chip_smoke.py --a2a-rank RANK WORLD
    STORE OUT``): on meshes (2, 4) and (1, 8), ``moe_ffn_a2a`` at capacity
    factor 8.0 and 1.0 on the card and at 1.0 with CPU tensors, the output
    and the gradients of sum(out**2) with respect to x and the
    parameters; rank 0 also runs ``moe_ffn_dense_reference`` on the card
    and writes everything to ``OUT`` (an npz)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)        # 8 ranks on the host's 8 cores
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.moe_a2a import moe_ffn_a2a, transport

    spec8, params, x = a2a_inputs(torch)

    def run(fn, dev):
        p = {k: v.to(dev, copy=True).requires_grad_()
             for k, v in params.items()}
        xx = x.to(dev, copy=True).requires_grad_()
        y = fn(p, xx)
        (y ** 2).sum().backward()
        return {"y": y, "x": xx.grad, **{k: v.grad for k, v in p.items()}}

    res = {"dense": run(lambda p, xx: moe.moe_ffn_dense_reference(
        p, xx, spec8), "cuda")}
    for shape in A2A_MESHES:
        meshes = {dev: make_mesh(shape, ("data", "model"), device=dev)
                  for dev in ("cuda", "cpu")}
        if rank == 0:
            print(f"mesh {shape}: the exchange's transport on the card is "
                  f"{transport(meshes['cuda'].get_group('model'), 'cuda')!r}"
                  " (gloo: the buffers go to the host and back)", flush=True)
        for cf, devs in ((8.0, ("cuda",)), (1.0, ("cuda", "cpu"))):
            spec = dataclasses.replace(spec8, capacity_factor=cf)
            for dev in devs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[f"{shape}, {cf}, {dev}"] = run(
                    lambda p, xx: moe_ffn_a2a(p, xx, spec, "swiglu",
                                              meshes[dev],
                                              fsdp_axes=("data",)), dev)
                torch.cuda.synchronize()
                if rank == 0:
                    print(f"mesh {shape}, capacity {cf}, {dev}: forward and "
                          f"backward {time.perf_counter() - t0:.3f} s",
                          flush=True)
    if rank == 0:
        np.savez(out, **{f"{run_name}|{k}": v.detach().cpu().numpy()
                         for run_name, r in res.items()
                         for k, v in r.items()})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_a2a(torch, np):
    """Phase 57: the all-to-all MoE on 8 gloo ranks that share the card
    (NCCL refuses two ranks on one device), each its own process running
    its experts' products on the card: at capacity factor 8.0 the output
    and gradients within ``A2A_TOL`` of ``moe_ffn_dense_reference`` on the
    card; at 1.0 (tokens drop) within ``A2A_TOL`` of the same run with CPU
    tensors.
    The ranks must finish within 300 s; they are killed otherwise."""
    import shutil

    root = ROOT / "build" / "chip_smoke_a2a"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = root / "a2a.npz"
    logs = [open(root / f"rank{r}.log", "w") for r in range(A2A_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-X", "faulthandler", str(Path(__file__).resolve()),
         "--a2a-rank", str(r), str(A2A_WORLD), str(root / "store"),
         str(out)],
        stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT)
        for r in range(A2A_WORLD)]
    deadline = time.monotonic() + 300
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for line in (root / "rank0.log").read_text().splitlines()[-20:]:
        print(f"  rank 0: {line}")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in bad[:1]:
        print((root / f"rank{r}.log").read_text()[-3000:])
    check(not bad, f"ranks {bad} failed (exit codes "
          f"{[procs[r].returncode for r in bad]})")
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    names = ("y", "x", "router", "w1", "w3", "w2")
    for shape in A2A_MESHES:
        for cf, dev, want in ((8.0, "cuda", "dense"),
                              (1.0, "cuda", f"{shape}, 1.0, cpu")):
            got = f"{shape}, {cf}, {dev}"
            shares = {}
            for n in names:
                ref = res[f"{want}|{n}"]
                gap = float(np.abs(res[f"{got}|{n}"] - ref).max())
                peak = float(np.abs(ref).max())
                shares[n] = gap / max(1.0, peak)
                print(f"  {got} against {want}, {n}: {gap:.3e} (largest "
                      f"{peak:.3e})")
            worst = max(shares.values())
            check(worst <= A2A_TOL, f"{got} against {want}: {worst:.3e} of "
                  "max(1, the largest)")
        drop = float(np.abs(res[f"{shape}, 1.0, cuda|y"]
                            - res["dense|y"]).max())
        print(f"  {shape}, capacity 1.0 against the dense oracle: "
              f"{drop:.3e} (tokens drop)")
        check(drop > 1e-2, "capacity 1.0 dropped nothing")
    shutil.rmtree(root, ignore_errors=True)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_sharded_restore(torch, np):
    """Phase 58: one NCCL rank, ``make_host_mesh("cuda")`` (data 1, model
    1): llsc-100m's train state (float32 masters and AdamW moments, on the
    card) saved, then restored through ``restore_checkpoint(...,
    shardings=param_shardings(mesh, template))``: every tensor leaf a
    DTensor with its sharding's placements whose ``full_tensor()`` equals
    the saved leaf.  The files go to build/ and are removed."""
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, mesh_shape
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import train_step as ts

    root = ROOT / "build" / "chip_smoke_sharded_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device="cuda")
        check(mesh_shape(mesh) == {"data": 1, "model": 1},
              f"host mesh {mesh_shape(mesh)}")
        cfg = get_config("llsc-100m")
        ocfg = ts.default_opt_cfg(cfg)
        state = ts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    ocfg, device="cuda")
        t0 = time.perf_counter()
        ck.save_checkpoint(str(root), 1, state)
        save_s = time.perf_counter() - t0
        template = ts.init_train_state_shape(cfg, ocfg)
        shardings = param_shardings(mesh, template)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, meta = ck.restore_checkpoint(str(root), 1, template, shardings,
                                          device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(meta["step"] == 1 and got.opt.step == state.opt.step,
              "the restored step differs")
        pairs = [(flat(got.params), flat(state.params),
                  flat(shardings.params))]
        pairs += [(flat(getattr(got.opt, n)), flat(getattr(state.opt, n)),
                   flat(getattr(shardings.opt, n))) for n in ("m", "v")]
        n = 0
        for got_t, want_t, sh in pairs:
            for key, t in got_t.items():
                check(isinstance(t, DTensor), f"{key} is not a DTensor")
                check(tuple(t.placements) == sh[key].placements,
                      f"{key}: placements {t.placements}")
                check(torch.equal(t.full_tensor(), want_t[key]),
                      f"{key}: full_tensor() differs from the saved leaf")
                n += 1
        n_bytes = sum(f.stat().st_size for f in root.rglob("*")
                      if f.is_file())
        print(f"  {n} leaves restored as DTensors on mesh "
              f"{mesh_shape(mesh)} ({n_bytes:,} bytes saved in "
              f"{save_s:.2f} s, restored in {restore_s:.2f} s), each "
              "full_tensor() the saved leaf")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)


# The dry-run's train shape: phase 11's batch, passed to probe_costs
# directly (it is not one of the assigned SHAPES).
DRY_RUN_SHAPE = ("smoke_train", 256, 8, "train")


def dry_run_probe(out) -> int:
    """``chip_smoke.py --dry-run-probe OUT``, phase 59's subprocess: the
    port's ``probe_costs`` of llsc-100m at ``DRY_RUN_SHAPE`` on a 1 x 1
    mesh over a one-rank ``"fake"`` group (no card), its result and
    seconds written to ``OUT`` as JSON.  A process of its own, so that no
    group outlives it."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    with dryrun.fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        cost = dryrun.probe_costs(get_config("llsc-100m"),
                                  ShapeSpec(*DRY_RUN_SHAPE), mesh)
    cost["seconds"] = time.perf_counter() - t0
    Path(out).write_text(json.dumps(cost))
    return 0


def phase_dry_run(torch, model_lib, smi, train):
    """Phase 59: the port's dry-run of phase 11's llsc-100m train step
    (``dry_run_probe``, in a subprocess; meant to take 30 s at most: its
    seconds are printed) against what phase
    11 measured (``train``: its median step, peak memory and registry
    entry).  Prints the counted FLOPs against 6 N D, the compute and
    memory terms against the measured step (the step must take at least
    the larger: a bound above it means the count is wrong), checks that
    the counted arguments are exactly the bytes of an llsc-100m
    ``TrainState`` and one 8 x 256 batch built on the card, prints temp +
    arguments against ``max_memory_allocated`` with the ratio (no bound),
    and the roofline verdict of the job's published duty, step and HBM."""
    import shutil

    from torch.utils._pytree import tree_flatten

    from repro_torch.configs import get_config
    from repro_torch.roofline import analysis
    from repro_torch.train import train_step as ts

    root = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out, log = root / "cost.json", root / "probe.log"
    cfg = get_config("llsc-100m")
    _, S, B, _ = DRY_RUN_SHAPE
    with open(log, "w") as f:
        probe = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--dry-run-probe", str(out)],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
        try:
            # while the probe counts: the arguments it should count,
            # built on the card
            t0 = time.perf_counter()
            state = ts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                        ts.default_opt_cfg(cfg),
                                        device="cuda")
            batch = {k: torch.zeros((B, S), dtype=torch.int32,
                                    device="cuda")
                     for k in ("tokens", "labels")}
            built = sum(t.numel() * t.element_size()
                        for t in tree_flatten((state, batch))[0]
                        if isinstance(t, torch.Tensor))
            torch.cuda.synchronize()
            t_built = time.perf_counter() - t0
            del state, batch
            probe.wait(timeout=120)
        finally:
            if probe.poll() is None:
                probe.kill()
                probe.wait()
    check(probe.returncode == 0, f"the dry-run probe exited "
          f"{probe.returncode}: {log.read_text()[-3000:]}")
    cost = json.loads(out.read_text())
    shutil.rmtree(root, ignore_errors=True)
    mf = model_lib.model_flops(cfg, B * S, training=True)
    terms = analysis.roofline({"flops": cost["flops"],
                               "bytes accessed": cost["bytes"]}, "",
                              n_devices=1, model_flops_global=mf)
    print(f"dry-run of {B} x {S} tokens, {cost['probe']}, no perf flags "
          f"(attention plain and full S x S, as the reference's default), "
          f"remat {cfg.remat!r}, counted in {cost['seconds']:.1f} s: "
          f"{cost['flops']:.6e} FLOPs a step against 6 N D = {mf:.6e} "
          f"({cost['flops'] / mf:.4f} x; the recompute of remat 'full' "
          "adds a forward), "
          f"{cost['bytes']:.6e} bytes (eager, unfused), collectives "
          f"{cost['collective']}")
    med = train["median_s"]
    bound = max(terms.compute_s, terms.memory_s)
    print(f"[{smi}] compute term {terms.compute_s * 1e3:.3f} ms, memory term "
          f"{terms.memory_s * 1e3:.3f} ms (H100 SXM data sheet, 700 W) "
          f"against phase 11's measured median step {med * 1e3:.3f} ms: "
          f"the bound is {bound / med:.4f} of the step")
    check(med >= bound, f"the dry-run's bound {bound * 1e3:.3f} ms exceeds "
          f"the measured step {med * 1e3:.3f} ms: the count is wrong")
    mem = cost["memory_analysis"]
    print(f"argument_size_in_bytes {mem['argument_size_in_bytes']} against "
          f"{built} bytes of a TrainState and a batch built on the card "
          f"(in {t_built:.1f} s)")
    check(mem["argument_size_in_bytes"] == built,
          "the dry-run's arguments are not the train state's bytes")
    est = mem["temp_size_in_bytes"] + mem["argument_size_in_bytes"]
    peak = train["peak_bytes"]
    print(f"[{smi}] temp + argument {est / 2 ** 20:.1f} MiB (eager, no "
          f"flash, a step's live shards at their peak) against phase 11's "
          f"max_memory_allocated {peak / 2 ** 20:.1f} MiB: ratio "
          f"{est / peak:.4f}")
    pub = train["published"]
    verdict = analysis.verdict_from_monitoring(pub.duty_cycle,
                                               pub.step_time_s,
                                               pub.hbm_used_gb)
    print(f"[{smi}] verdict_from_monitoring(duty {pub.duty_cycle:.6f}, step "
          f"{pub.step_time_s:.6f} s, HBM {pub.hbm_used_gb:.3f} GB) of "
          f"train:{cfg.name}: {verdict!r}")


@contextlib.contextmanager
def phase_clock(seconds, phase, title, smi):
    """Print phase ``phase``'s header and, after it, its seconds (kept in
    ``seconds``)."""
    print(f"=== {phase}. {title} [{smi}] ===")
    t0 = time.perf_counter()
    yield
    seconds[phase] = time.perf_counter() - t0
    print(f"  phase {phase}: {seconds[phase]:.1f} s")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref, ssd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import model as model_lib
    from repro_torch.models import perf_flags as perf
    from repro_torch.monitor import JobRegistry
    from repro_torch.roofline import hw
    from repro_torch.serve import engine

    counters = {"flash_attention": (fa, "launches"),
                "rmsnorm": (rn, "launches"),
                "gated_rmsnorm": (rn, "gated_launches"),
                "ssd_intra_chunk": (ssd, "launches")}
    registry = JobRegistry.global_registry()

    t_all = time.perf_counter()
    print("=== 1. card and versions ===")
    smi = nvidia_smi_line()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"python {platform.python_version()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {kind}: "
          f"{hw.device_memory_bytes(0) / 1e9:.2f} GB device memory; bounds "
          f"use H100 SXM data-sheet peaks (bf16 {hw.PEAK_FLOPS_BF16 / 1e12:.0f}"
          f" TFLOP/s, fp32 {hw.PEAK_FLOPS_FP32 / 1e12:.0f} TFLOP/s, HBM "
          f"{hw.HBM_BW / 1e12:.2f} TB/s)")

    print("=== 2. build (nvcc, one process per source) ===")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        libs = dict(zip(_build.SOURCES, pool.map(_build.build,
                                                 _build.SOURCES)))
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    spills, regs = {}, {}
    for name, path in sorted(libs.items()):
        log = path.with_suffix(".log")
        entry = name
        for line in (log.read_text().splitlines() if log.exists() else ()):
            m = re.search(r"\d([a-z][a-z_]*_kernel)I(\w+?)E+v", line)
            if "Compiling entry" in line and m:   # mangled name, template
                entry = f"{m.group(1)}<{m.group(2)}>"  # args as mangled
            elif "registers" in line or "spill" in line:
                print(f"  {entry} ptxas: {line.split(':', 1)[-1].strip()}")
                m = re.search(r"(\d+) bytes spill stores", line)
                if m:
                    spills[entry] = int(m.group(1))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    regs[entry] = int(m.group(1))
    for entry, (D, split) in NEW_FLASH_INSTANCES.items():
        check(spills.get(entry) == 0, f"{entry} spills "
              f"{spills.get(entry)} bytes (or was not compiled)")
        block_m, block_n, stages, smem = fa._wgmma_tile(D, split)
        print(f"  {entry}: no spills; {block_m} query rows x {block_n} keys "
              f"a tile, {stages} stages, {smem} bytes of dynamic shared "
              "memory")
    for entry in OTHER_FLASH_INSTANCES:
        check(spills.get(entry) == 0, f"{entry} spills "
              f"{spills.get(entry)} bytes (or was not compiled)")
    print(f"  no spills in {', '.join(OTHER_FLASH_INSTANCES)}")
    for entry, (n, out) in NEW_SSD_INSTANCES.items():
        check(spills.get(entry) == 0, f"{entry} spills "
              f"{spills.get(entry)} bytes (or was not compiled)")
        print(f"  {entry}: no spills; state {n}, {out} y; {regs.get(entry)} "
              f"registers at launch (setmaxnreg 40 / 232), "
              f"{ssd.plan(1, 256, 1, 64, 1, n).smem} bytes of dynamic shared "
              "memory")

    print("=== 3. kernels against their plain versions on the card ===")
    rows = phase_kernels(torch, fa, rn, ref, hw)
    rows += phase_mamba_kernels(torch, rn, ssd, ref, hw)

    print("=== 4. serve llsc-100m, full width and depth, bf16, flash_kernel ===")
    cfg = get_config("llsc-100m")
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cuda")
    serve = dict(lens=(128, 256), max_seq=512)
    phase_serve(torch, cfg, params, engine, counters, perf, requests=4, new=8,
                **serve)  # warm-up
    eng, stats, counts = phase_serve(torch, cfg, params, engine, counters,
                                     perf, **serve)
    expect = serve_launches(cfg, len(eng.prefill_s), stats["steps"])
    report_serve(torch, np, eng, stats, counts, expect, cfg, registry)
    serve_llsc = counts

    print("=== 5. card vs CPU, llsc-100m full width, float32 ===")
    card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES, cfg, 128,
                scalar_norm=True)

    print("=== 6. the first 4 requests of phase 4 under torch.profiler ===")
    profile_wave(torch, cfg, params, engine, counters, perf, serve,
                 ("flash_attention", "rmsnorm"))
    del params

    print("=== 7. serve mamba2-370m, full width and depth, bf16 ===")
    cfg = get_config("mamba2-370m")
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cuda")
    serve = dict(lens=(128, 320), max_seq=384)
    phase_serve(torch, cfg, params, engine, counters, perf, requests=4, new=8,
                **serve)  # warm-up
    eng, stats, counts = phase_serve(torch, cfg, params, engine, counters,
                                     perf, **serve)
    # 49 norms a pass: no ln2, d_ff 0
    expect = serve_launches(cfg, len(eng.prefill_s), stats["steps"])
    report_serve(torch, np, eng, stats, counts, expect, cfg, registry)
    serve_mamba = counts

    print("=== 8. card vs CPU, mamba2-370m full width, float32 ===")
    card_vs_cpu(torch, np, model_lib, perf, engine.TIME_AXIS_LEAVES, cfg, 320)

    print("=== 9. the first 4 requests of phase 7 under torch.profiler ===")
    profile_wave(torch, cfg, params, engine, counters, perf, serve,
                 ("rmsnorm", "gated_rmsnorm", "ssd_intra_chunk"))

    # the engine holds the weights too: release both, or mamba2-370m's
    # 703 MiB of bf16 weights stay allocated through the later phases
    del params, eng

    print("=== 10. gradients of the five kernel entry points on the card ===")
    phase_grads(torch, ops, ref, counters)

    print(f"=== 11. train llsc-100m, full width and depth, bf16, "
          f"flash_kernel, remat 'full', through launch.train [{smi}] ===")
    by_path = {"serve llsc-100m": dict(serve_llsc),
               "serve mamba2-370m": dict(serve_mamba)}
    llsc_train = {}
    by_path["train llsc-100m"] = phase_train(
        torch, np, counters, registry, perf, smi, "llsc-100m",
        ("--flags", "flash_kernel"), phase=11, stats=llsc_train)

    print("=== 13. card vs CPU, llsc-100m training, full width, float32 ===")
    train_card_vs_cpu(torch, perf, dataclasses.replace(
        get_config("llsc-100m"), dtype="float32"))

    print(f"=== 14. train mamba2-370m, full width and depth, bf16, remat "
          f"'full', through launch.train [{smi}] ===")
    by_path["train mamba2-370m"] = phase_train(
        torch, np, counters, registry, perf, smi, "mamba2-370m", phase=14)

    print("=== 16. card vs CPU, mamba2-370m training, full width, 4 of 48 "
          "layers, float32 ===")
    train_card_vs_cpu(torch, perf, dataclasses.replace(
        get_config("mamba2-370m"), dtype="float32", n_layers=4))

    print(f"=== 17. remat 'none', 'full' and 'dots': one llsc-100m forward "
          f"and backward, full width, bf16 [{smi}] ===")
    phase_remat(torch, perf, counters, smi)

    print(f"=== 18. checkpoint, crash and resume on the card, llsc-100m "
          f"[{smi}] ===")
    phase_checkpoint(torch, np, smi)

    print(f"=== 19. serve granite-moe-1b-a400m, full width and depth, bf16, "
          f"flash_kernel [{smi}] ===")
    by_path["serve granite-moe-1b-a400m"], cfg = phase_granite_serve(
        torch, np, model_lib, engine, counters, perf, registry, smi)

    print(f"=== 22. train granite-moe-1b-a400m, full width and depth, bf16, "
          f"flash_kernel, remat 'full', through launch.train [{smi}] ===")
    by_path["train granite-moe-1b-a400m"] = phase_train(
        torch, np, counters, registry, perf, smi, "granite-moe-1b-a400m",
        ("--flags", "flash_kernel"), phase=22)

    print("=== 24. card vs CPU, granite-moe-1b-a400m training, full width, 4 "
          "of 24 layers, float32, aux losses (0.01, 1e-3) ===")
    with recorded_routes():
        train_card_vs_cpu(torch, perf, dataclasses.replace(
            cfg, dtype="float32", n_layers=4), aux_weights=(0.01, 1e-3))

    print(f"=== 25. serve jamba-1.5-large-398b, full width, "
          f"{JAMBA_SERVE_LAYERS} layers, bf16, flash_kernel [{smi}] ===")
    by_path[f"serve {JAMBA}, {JAMBA_SERVE_LAYERS} layers"] = \
        phase_jamba_serve(torch, np, model_lib, engine, counters, perf, hw,
                          registry, smi)
    phase_jamba_checks(torch, np, model_lib, engine, perf)

    print(f"=== 30. serve gemma3-1b, full width and depth, bf16, flash_kernel "
          f"[{smi}] ===")
    by_path[f"serve {GEMMA}"] = phase_gemma_serve(
        torch, np, model_lib, engine, counters, perf, registry, smi)
    print(f"=== 32. train gemma3-1b, full width and depth, bf16, "
          f"flash_kernel, remat 'full', through launch.train [{smi}] ===")
    by_path[f"train {GEMMA}"] = phase_train(
        torch, np, counters, registry, perf, smi, GEMMA,
        ("--flags", "flash_kernel"), phase=32)
    phase_gemma_checks(torch, np, model_lib, engine, perf)

    for phase, arch in ((36, "qwen1.5-4b"), (37, "phi3-medium-14b"),
                        (39, "minicpm3-4b")):
        print(f"=== {phase}. serve {arch}, full width and depth, bf16, "
              f"flash_kernel [{smi}] ===")
        by_path[f"serve {arch}"] = phase_qpm_serve(
            torch, np, model_lib, engine, counters, perf, hw, registry, smi,
            arch, profile_phase=38 if arch == "phi3-medium-14b" else None)
    for phase, arch in ((40, "qwen1.5-4b"), (42, "minicpm3-4b")):
        print(f"=== {phase}. train {arch}, full width, "
              f"{QPM_TRAIN_LAYERS} layers, bf16, remat 'full', through "
              f"launch.train [{smi}] ===")
        gc.collect()
        torch.cuda.empty_cache()
        counts = phase_train(
            torch, np, counters, registry, perf, smi, arch,
            ("--flags", "flash_kernel") if arch == "qwen1.5-4b" else (),
            phase=phase, layers=QPM_TRAIN_LAYERS)
        flash, norms = QPM_STEP[arch]
        check(counts["flash_attention"] == TRAIN_STEPS * flash
              and counts["rmsnorm"] == TRAIN_STEPS * norms,
              f"{arch}: {counts} in {TRAIN_STEPS} steps, not {flash} flash "
              f"and {norms} "
              "RMSNorm a step")
        by_path[f"train {arch}, {QPM_TRAIN_LAYERS} layers"] = counts
    phase_qpm_checks(torch, np, model_lib, engine, perf)
    phase_whisper_internvl2(torch, np, model_lib, engine, counters, perf, hw,
                            registry, smi, by_path)
    phase_whisper_internvl2_checks(torch, np, model_lib, engine, perf)

    seconds = {}
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock(seconds, 55, "serve llsc-100m, full width and depth, "
                     "bf16, flash_kernel, sampled (temperature 0.8, top 40, "
                     "seed 0) against greedy", smi):
        by_path["serve llsc-100m, sampled"] = phase_sampling(
            torch, np, model_lib, engine, counters, perf, registry, smi)
    with phase_clock(seconds, 56, "banded=True against banded_local, "
                     "reduced gemma3-1b, float32", smi):
        phase_banded(torch, perf)
    with phase_clock(seconds, 57, f"the all-to-all MoE on {A2A_WORLD} gloo "
                     "ranks sharing the card, meshes (2, 4) and (1, 8)", smi):
        phase_a2a(torch, np)
    with phase_clock(seconds, 58, "restore_checkpoint with shardings, one "
                     "NCCL rank, llsc-100m's train state", smi):
        phase_sharded_restore(torch, np)
    with phase_clock(seconds, 59, "the dry-run of llsc-100m's train step "
                     "against phase 11", smi):
        phase_dry_run(torch, model_lib, smi, llsc_train)
    print(f"phases 55-59: {sum(seconds.values()):.1f} s")

    print(f"=== 60. summary (whole run {time.perf_counter() - t_all:.1f} s) "
          "===")
    for path, counts in by_path.items():
        print(f"launches, {path}: {counts}")
    for row in rows:
        row["launches"] = sum(c[row["name"]] for c in by_path.values())
        check(row["launches"] > 0, f"{row['name']} never launched on a main "
              "path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--a2a-rank"] and (SRC / "repro_torch").is_dir():
        sys.exit(a2a_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                          sys.argv[5]))
    if sys.argv[1:2] == ["--dry-run-probe"] and (SRC / "repro_torch").is_dir():
        sys.exit(dry_run_probe(sys.argv[2]))
    sys.exit(main())
