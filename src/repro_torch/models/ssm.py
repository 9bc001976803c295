"""Mamba-2 SSD mixer (counterpart of ``repro.models.ssm``).

The chunked SSD algorithm [arXiv:2405.21060]: within a chunk the quadratic
"attention-like" form, which is the SSD intra-chunk kernel's work
(``kernels.ops.ssd_intra_chunk``, one launch for all chunks of a call),
across chunks a linear state recurrence in plain PyTorch.  Decode is the
O(1) recurrent step.  All decay math is fp32, cumulative sums included
(``kernels.ref.cumsum_f32``), as in the reference.  The reference's
``_segsum`` is ``kernels.ref.segsum``, the building block of the kernel's
plain version.

Shapes (grouped heads): x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,G,N] with
H = G * HG heads per group.  Decode updates the conv and ssd cache views
it is given in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import cumsum_f32
from repro_torch.models.layers import Leaf, zeros

F32 = torch.float32


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def _a_log(shape):
    """log(1..H) along the last axis (a stacked leaf repeats it)."""
    a = torch.log(torch.arange(1, shape[-1] + 1, dtype=F32))
    return a.expand(shape).clone()


def _dt_bias(shape):
    return torch.log(torch.expm1(torch.full(shape, 0.01, dtype=F32)))


def mamba2_spec(d_model: int, spec):
    """The mixer's parameter leaves, as ``init_mamba2`` of the reference
    makes them: A_log, D and dt_bias are float32 whatever the model dtype,
    conv_b starts at zero, the norm scale at one, dt_bias at
    softplus^-1(0.01)."""
    d_in = spec.d_inner(d_model)
    H = spec.n_heads(d_model)
    G, N, K = spec.n_groups, spec.d_state, spec.d_conv
    conv_ch = d_in + 2 * G * N
    d_proj = 2 * d_in + 2 * G * N + H
    return {
        "in_proj": Leaf((d_model, d_proj), d_model ** -0.5),
        "conv_w": Leaf((K, conv_ch), K ** -0.5),
        "conv_b": Leaf((conv_ch,), fixed=zeros),
        "A_log": Leaf((H,), fixed=_a_log, fp32=True),
        "D": Leaf((H,), fp32=True),
        "dt_bias": Leaf((H,), fixed=_dt_bias, fp32=True),
        "norm": Leaf((d_in,)),
        "out_proj": Leaf((d_in, d_model), d_in ** -0.5),
    }


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------


def ssd_chunked(x, dt, A, B, C, *, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x [b,s,h,p]; dt [b,s,h] (>0, fp32); A [h] (<0, fp32); B,C [b,s,g,n].
    Returns (y [b,s,h,p] in x's dtype, final_state [b,g,hg,p,n] fp32).
    y_diag + y_off is summed in fp32 and cast once, as the reference does.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk
    l = chunk
    dt = dt.to(F32)
    A = A.to(F32)

    # Intra-chunk (quadratic within chunk): every chunk in one kernel call
    y_diag = ops.ssd_intra_chunk(
        x.reshape(b * nc, l, h, p), dt.reshape(b * nc, l, h).contiguous(),
        A.contiguous(), B.reshape(b * nc, l, g, n),
        C.reshape(b * nc, l, g, n), out_dtype=F32)

    # chunked views; heads arranged as (g, hg)
    xc = x.reshape(b, nc, l, g, hg, p)
    dtc = dt.reshape(b, nc, l, g, hg)
    Bc = B.reshape(b, nc, l, g, n).to(F32)
    Cc = C.reshape(b, nc, l, g, n).to(F32)
    dtA = dtc * A.reshape(g, hg)                           # [b,nc,l,g,hg]
    xdt = xc.to(F32) * dtc[..., None]                      # x * dt

    # Per-chunk final states
    A_cum = cumsum_f32(dtA, 2)                             # [b,nc,l,g,hg]
    A_last = A_cum[:, :, -1]                               # [b,nc,g,hg]
    decay_to_end = torch.exp(A_last[:, :, None] - A_cum)   # [b,nc,l,g,hg]
    chunk_states = torch.einsum("bclgn,bclgh,bclghp->bcghpn",
                                Bc, decay_to_end, xdt)

    # Inter-chunk recurrence
    if initial_state is None:
        state = torch.zeros((b, g, hg, p, n), dtype=F32, device=x.device)
    else:
        state = initial_state.to(F32)
    chunk_decay = torch.exp(A_last)                        # [b,nc,g,hg]
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, ..., None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, 1)                     # [b,nc,g,hg,p,n]

    # Inter-chunk contribution
    state_decay = torch.exp(A_cum)                         # [b,nc,l,g,hg]
    y_off = torch.einsum("bclgn,bcghpn,bclgh->bclghp",
                         Cc, prev_states, state_decay)

    y = (y_diag.reshape(b, nc, l, g, hg, p) + y_off).reshape(b, sp, h, p)
    return y[:, :s].to(x.dtype), state


def ssd_decode_step(state, x, dt, A, B, C):
    """One-token recurrence.  state [b,g,hg,p,n]; x [b,h,p]; dt [b,h];
    B,C [b,g,n].  Returns (y [b,h,p] in x's dtype, new_state fp32)."""
    b, h, p = x.shape
    g = B.shape[1]
    hg = h // g
    xg = x.reshape(b, g, hg, p).to(F32)
    dtg = dt.reshape(b, g, hg).to(F32)
    Ag = A.reshape(g, hg).to(F32)
    decay = torch.exp(dtg * Ag[None])                      # [b,g,hg]
    add = torch.einsum("bgn,bghp,bgh->bghpn", B.to(F32), xg, dtg)
    state = state.to(F32) * decay[..., None, None] + add
    y = torch.einsum("bgn,bghpn->bghp", C.to(F32), state)
    return y.reshape(b, h, p).to(x.dtype), state


# --------------------------------------------------------------------------
# Depthwise causal conv
# --------------------------------------------------------------------------


def causal_conv(x, w, b):
    """x [B,S,C]; w [K,C]; depthwise causal conv + bias, as the reference's
    shifted sums in x's dtype (not a cuDNN convolution, which would run
    float32 in TF32 on the card)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y + b


def conv_decode_step(conv_state, x_new, w, b):
    """conv_state [B,K-1,C]; x_new [B,C] -> (y [B,C], new_state)."""
    full = torch.cat([conv_state, x_new[:, None]], dim=1)  # [B,K,C]
    y = torch.einsum("bkc,kc->bc", full, w) + b
    return y, full[:, 1:]


# --------------------------------------------------------------------------
# Mamba-2 block (mixer)
# --------------------------------------------------------------------------


def _gated_norm(scale, y, z, eps):
    """RMSNorm(y * silu(z)), the Mamba-2 gated norm, through the gated
    RMSNorm kernel."""
    return ops.gated_rmsnorm(y, z, scale, eps)


def _split_proj(proj, d_in, G, N):
    z = proj[..., :d_in]
    xBC = proj[..., d_in:2 * d_in + 2 * G * N]
    dt_raw = proj[..., 2 * d_in + 2 * G * N:]
    return z, xBC, dt_raw


def _dims(cfg):
    spec = cfg.ssm
    return (spec.d_inner(cfg.d_model), spec.n_heads(cfg.d_model),
            spec.n_groups, spec.d_state, spec.d_conv, spec.head_dim)


def mamba2_forward(params, x, cfg, *, initial_state=None):
    """Full-sequence Mamba-2 mixer.  x [B,S,D] -> (y, (conv_tail,
    ssd_state))."""
    d_in, H, G, N, K, P = _dims(cfg)
    Bsz, S, _ = x.shape

    proj = x @ params["in_proj"]
    z, xBC, dt_raw = _split_proj(proj, d_in, G, N)
    if S < K - 1:  # a prompt shorter than the conv: left-pad the tail
        conv_tail = F.pad(xBC, (0, 0, K - 1 - S, 0))
    else:
        conv_tail = xBC[:, S - (K - 1):]
    xBC = F.silu(causal_conv(xBC, params["conv_w"], params["conv_b"]))
    xs = xBC[..., :d_in].reshape(Bsz, S, H, P)
    Bmat = xBC[..., d_in:d_in + G * N].reshape(Bsz, S, G, N)
    Cmat = xBC[..., d_in + G * N:].reshape(Bsz, S, G, N)
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    layout = _head_layout(xs, G) if initial_state is None else None
    if layout is not None:
        y, final_state = _ssd_on_shards(xs, dt, A, Bmat, Cmat,
                                        cfg.ssm.chunk, layout)
    else:
        y, final_state = ssd_chunked(xs, dt, A, Bmat, Cmat,
                                     chunk=cfg.ssm.chunk,
                                     initial_state=initial_state)
    y = y + xs * params["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, d_in)
    y = _gated_norm(params["norm"], y, z, cfg.norm_eps)
    return y @ params["out_proj"], (conv_tail, final_state)


def _head_layout(xs, G: int):
    """Where ``xs`` [b,s,h,p] is a ``DTensor`` in a sharding-hint context
    with a mesh (the dry-run's), its one group's heads divide the tensor
    axis: (mesh, placements of a [b, s, h, ...] tensor with the batch over
    the FSDP axes where it divides and the heads over the tensor axis,
    placements of B and C [b, s, g, n] and of A [h]).  Else None."""
    from repro_torch.models.sharding_hints import hint_mesh

    mesh = hint_mesh(xs) if G == 1 else None
    if mesh is None:
        return None
    from repro_torch.launch.mesh import fsdp_axes, tp_axis
    from repro_torch.launch.sharding import _axes_or_none, to_placements

    tp = _axes_or_none(mesh, xs.shape[2], tp_axis(mesh))
    if tp is None:
        return None
    b = _axes_or_none(mesh, xs.shape[0], fsdp_axes(mesh))
    return (mesh, to_placements((b, None, tp), mesh),
            to_placements((b,), mesh), to_placements((tp,), mesh))


def _ssd_on_shards(xs, dt, A, B, C, chunk, layout):
    """``ssd_chunked`` on each device's heads (``local_map``): heads are
    independent given the one group's B and C, so a device scans its own
    ``h / n`` heads of its rows, where DTensor would replicate the scan
    over the tensor axis.  The final state [b, 1, h, p, n] shards its
    heads as the cache's ``ssd`` leaf does."""
    from torch.distributed.tensor.experimental import local_map

    mesh, heads, rows, per_head = layout
    return local_map(
        lambda xs, dt, A, B, C: ssd_chunked(xs, dt, A, B, C, chunk=chunk),
        out_placements=(heads, heads),
        in_placements=(heads, heads, per_head, rows, rows),
        device_mesh=mesh, redistribute_inputs=True)(xs, dt, A, B, C)


def mamba2_decode(params, x, cfg, conv_state, ssd_state):
    """One-token Mamba-2 step.  x [B,1,D] -> (y [B,1,D], conv_state,
    ssd_state), the two states being the given cache views, updated in
    place."""
    d_in, H, G, N, _, P = _dims(cfg)
    Bsz = x.shape[0]

    proj = x[:, 0] @ params["in_proj"]
    z, xBC, dt_raw = _split_proj(proj, d_in, G, N)
    xBC_c, new_conv = conv_decode_step(conv_state, xBC, params["conv_w"],
                                       params["conv_b"])
    xBC_c = F.silu(xBC_c)
    xs = xBC_c[..., :d_in].reshape(Bsz, H, P)
    Bmat = xBC_c[..., d_in:d_in + G * N].reshape(Bsz, G, N)
    Cmat = xBC_c[..., d_in + G * N:].reshape(Bsz, G, N)
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    y, new_ssd = ssd_decode_step(ssd_state, xs, dt, A, Bmat, Cmat)
    conv_state.copy_(new_conv)
    ssd_state.copy_(new_ssd)
    y = y + xs * params["D"].to(x.dtype)[None, :, None]
    y = y.reshape(Bsz, d_in)
    y = _gated_norm(params["norm"], y[:, None], z[:, None], cfg.norm_eps)[:, 0]
    return (y @ params["out_proj"])[:, None], conv_state, ssd_state


def ssd_reference(x, dt, A, B, C, *, initial_state=None):
    """Sequential oracle for tests: the plain per-step recurrence."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    state = (torch.zeros((b, g, h // g, p, n), dtype=F32, device=x.device)
             if initial_state is None else initial_state.to(F32))
    ys = []
    for t in range(s):
        y, state = ssd_decode_step(state, x[:, t], dt[:, t], A, B[:, t],
                                   C[:, t])
        ys.append(y)
    return torch.stack(ys, 1), state
