"""Mixture-of-experts FFN with sort/scatter dispatch (counterpart of
``repro.models.moe``), in plain PyTorch: the JAX package computes MoE with
no Pallas kernel, its expert products are einsums.

Tokens are taken in groups (``_pick_groups``): a prefill or a train step
makes one group of each batch row, a decode step groups whole rows.  In a
group of T tokens, each of the T * k token-expert assignments gets its
position in its expert's buffer from a stable argsort by expert id over the
token-major flattening of ``[T, k]``: earlier tokens take an expert's C
capacity rows first, and an assignment at or past C is dropped (it adds
nothing to its token).  The kept rows go into per-expert buffers
``[G, E, C, d]``, the experts run as products batched over E, and each
token's k weighted rows are gathered back and summed.

Everything stays on the device, with no host sync: no boolean-mask
indexing, ``nonzero``, ``item`` or data-sized allocation.  A dropped
assignment is written to one extra row per expert (index C), which is
sliced away; the pairs (expert, position < C) are unique, so the scatter
(``index_put`` without accumulation) is exact.

The combine sums in a fixed order, not with atomics: the k weighted rows of
a token, in the model dtype, are summed by one ``torch.sum`` over the k
axis, in rank order (largest router weight first); ATen accumulates a
bfloat16 sum in float32 and rounds once.  The reference adds the rows into
``[T, d]`` with a scatter-add in the model dtype, in the sorted order.  In
float32 the two differ by the order of k additions; in bfloat16 by that and
the reference's rounding after each add (``tests/test_torch_moe.py`` holds
them within the kernels' bf16 tolerance, 2e-2).

Under the ``moe_a2a`` PerfFlag, with a mesh in the sharding-hint context
(``launch.sharding.hint_context``) on which ``a2a_applicable`` holds,
``moe_ffn`` runs the expert-parallel all-to-all of ``models/moe_a2a.py``
instead, as the reference's.  The dispatch buffers take the
``"moe_dispatch"`` hint and the combined rows ``"moe_out"``; on one
device, and for plain tensors, neither does anything.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Leaf
from repro_torch.models.perf_flags import current as _perf
from repro_torch.models.sharding_hints import (current_hints, reshape,
                                               shard_hint)

F32 = torch.float32


def moe_spec(d_model: int, spec):
    """The MoE parameters as ``Leaf`` specs (the reference's ``init_moe``):
    an fp32 router [d, E] and the experts' w1, w3 [E, d, f] and w2 [E, f,
    d] in the model dtype."""
    E, f = spec.n_experts, spec.d_ff_expert
    std_in = d_model ** -0.5
    return {"router": Leaf((d_model, E), std_in, fp32=True),
            "w1": Leaf((E, d_model, f), std_in),
            "w3": Leaf((E, d_model, f), std_in),
            "w2": Leaf((E, f, d_model), f ** -0.5)}


def _route(logits, spec):
    """logits [..., E] fp32 -> (weights [..., k], expert ids [..., k]),
    largest first: a softmax over the top-k logits (``norm_topk_prob``), or
    the top-k of a softmax over every expert."""
    if spec.norm_topk_prob:
        vals, idx = torch.topk(logits, spec.top_k, dim=-1)
        return torch.softmax(vals, dim=-1), idx
    return torch.topk(torch.softmax(logits, dim=-1), spec.top_k, dim=-1)


def _positions(e_flat, E: int):
    """e_flat [G, T * k] expert ids, token-major -> each assignment's
    position in its expert's buffer, token-major: its rank among the
    assignments of the same expert in a stable sort by expert id.  The
    counts and starts per expert are scattered and summed in int64, so the
    result is exact in any order."""
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    counts = torch.zeros((e_flat.shape[0], E), dtype=torch.int64,
                         device=e_flat.device)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=1) - counts
    ranks = (torch.arange(e_flat.shape[1], device=e_flat.device)
             - torch.gather(starts, 1, e_sorted))
    return torch.empty_like(ranks).scatter_(1, order, ranks)


def _dispatch(x, e_flat, pos, E: int, C: int):
    """x [G, T, d]; e_flat, pos [G, T * k] token-major -> buf [G, E, C, d]
    holding the token row of each kept assignment at (expert, position):
    the pairs the reference's ``_dispatch_group`` writes."""
    G, T, d = x.shape
    k = e_flat.shape[1] // T
    rows = x[:, :, None, :].expand(G, T, k, d).reshape(G, T * k, d)
    g = torch.arange(G, device=x.device)[:, None]
    slot = torch.where(pos < C, pos, C)        # dropped -> the extra row C
    buf = x.new_zeros((G, E, C + 1, d)).index_put((g, e_flat, slot), rows)
    return buf[:, :, :C]


def _combine(out_buf, e_flat, pos, w_flat, k: int):
    """out_buf [G, E, C, d]; e_flat, pos, w_flat [G, T * k] token-major ->
    y [G, T, d] in the model dtype: each token's k rows weighted (zero
    where dropped) and summed over k in rank order (the module's note)."""
    G, _, C, d = out_buf.shape
    dt = out_buf.dtype
    g = torch.arange(G, device=out_buf.device)[:, None]
    rows = out_buf[g, e_flat, pos.clamp(max=C - 1)]
    scale = (pos < C).to(dt) * w_flat.to(dt)
    rows = rows * scale[..., None]
    return rows.view(G, -1, k, d).sum(dim=2)


def capacity(tokens_per_group: int, spec) -> int:
    return max(1, math.ceil(tokens_per_group * spec.top_k
                            * spec.capacity_factor / spec.n_experts))


def _pick_groups(B: int, S: int) -> int:
    if S > 1:
        return B  # one group per batch row
    # decode: group whole rows
    for g in (16, 8, 4, 2, 1):
        if B % g == 0 and B // g >= 1:
            return min(g, B)
    return 1


def _experts(params, buf, act: str):
    """buf [..., E, C, d] -> [..., E, C, d] through each expert's FFN."""
    h1 = torch.einsum("gecd,edf->gecf", buf, params["w1"])
    if act == "swiglu":
        h = F.silu(h1) * torch.einsum("gecd,edf->gecf", buf, params["w3"])
    else:       # jax.nn.gelu's default: the tanh approximation
        h = F.gelu(h1, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, params["w2"])


def moe_aux_losses(params, x, spec):
    """(load_balance, z) router losses for x [B,S,d] (fp32 scalars)."""
    xf = x.reshape(-1, x.shape[-1]).to(F32)
    logits = xf @ params["router"].to(F32)
    _, idx = _route(logits, spec)
    return load_balance_loss(logits, idx, spec), router_z_loss(logits)


def moe_ffn(params, x, spec, act: str = "swiglu", n_groups=None):
    """x [B, S, d] -> [B, S, d] in x's dtype.  The router logits are fp32
    (a bf16 router, as training's ``cast_params`` leaves it, is lifted
    back); the experts run in x's dtype."""
    if _perf().moe_a2a:
        from repro_torch.launch.mesh import fsdp_axes
        from repro_torch.models.moe_a2a import a2a_applicable, moe_ffn_a2a

        state = current_hints()
        mesh = state[0] if state else None
        if mesh is not None and a2a_applicable(x.shape, spec, mesh):
            return moe_ffn_a2a(params, x, spec, act, mesh,
                               fsdp_axes=fsdp_axes(mesh))

    B, S, d = x.shape
    G = n_groups or _pick_groups(B, S)
    T = (B * S) // G
    E, k = spec.n_experts, spec.top_k
    C = capacity(T, spec)
    xg = reshape(x, G, T, d)
    logits = xg.to(F32) @ params["router"].to(F32)        # [G, T, E]
    weights, idx = _route(logits, spec)
    e_flat, w_flat = idx.reshape(G, T * k), weights.reshape(G, T * k)
    layout = _shard_layout(xg, E)
    if layout is not None:
        return reshape(_moe_on_shards(params, xg, e_flat, w_flat, act, k,
                                      C, layout), B, S, d)
    pos = _positions(e_flat, E)
    buf = shard_hint(_dispatch(xg, e_flat, pos, E, C), "moe_dispatch")
    out_buf = shard_hint(_experts(params, buf, act), "moe_dispatch")
    y = shard_hint(_combine(out_buf, e_flat, pos, w_flat, k), "moe_out")
    return reshape(y, B, S, d)


def _shard_layout(xg, E: int):
    """Where ``xg`` [G, T, d] is a ``DTensor`` in a sharding-hint context
    with a mesh (the dry-run's): (mesh, pg, pe, ep), with ``pg`` the
    placements of a [G, ...] tensor whose groups shard as the
    ``"moe_dispatch"`` hint's first entry (the FSDP axes; replicated where
    G does not divide), ``pe`` those of a [G, E, C, d] buffer under that
    hint (experts over the tensor axis, where E divides), and ``ep`` the
    mesh dim the experts shard over, or None.  Else None."""
    state = current_hints()
    if state is None or state[0] is None or "moe_dispatch" not in state[1]:
        return None
    from torch.distributed.tensor import DTensor

    if not isinstance(xg, DTensor):
        return None
    from repro_torch.launch.sharding import _axes_or_none, to_placements

    mesh, hints = state
    g_entry, e_entry = hints["moe_dispatch"][:2]
    g_entry = _axes_or_none(mesh, xg.shape[0], g_entry)
    e_entry = _axes_or_none(mesh, E, e_entry)
    ep = None if e_entry is None else mesh.mesh_dim_names.index(e_entry)
    return (mesh, to_placements((g_entry,), mesh),
            to_placements((g_entry, e_entry), mesh), ep)


def _moe_on_shards(params, xg, e_flat, w_flat, act, k, C, layout):
    """The sort/scatter MoE on each device's shards, the reference's
    ``moe_dispatch`` / ``moe_out`` layout: a device holds its groups
    (``pg``) and, under expert parallelism, its ``E / n`` experts (``pe``).
    Positions, dispatch and combine run on the local shards
    (``local_map``): a device writes and reads only its own experts' rows,
    so the combine yields a partial sum over the expert axis, which the
    ``"moe_out"`` hint reduces.  Under expert parallelism the experts'
    products run on the local shards too, each device's experts gathered
    whole over the FSDP axes; else they are DTensor's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pg, pe, ep = layout
    E = params["w1"].shape[0]
    E_loc = E // mesh.size(ep) if ep is not None else E
    lo = mesh.get_local_rank(ep) * E_loc if ep is not None else 0

    def local_experts(e_flat):
        mine = (e_flat >= lo) & (e_flat < lo + E_loc)
        return mine, (e_flat - lo).clamp(0, E_loc - 1)

    def dispatch(xg, e_flat):
        pos = _positions(e_flat, E)
        mine, e_loc = local_experts(e_flat)
        # another device's assignment goes to the dropped row C
        return pos, _dispatch(xg, e_loc, torch.where(mine, pos, C), E_loc, C)

    def combine(out_buf, e_flat, pos, w_flat):
        mine, e_loc = local_experts(e_flat)
        return _combine(out_buf, e_loc, pos,
                        torch.where(mine, w_flat, 0.0), k)

    py = list(pg)
    if ep is not None:
        py[ep] = Partial()
    pos, buf = local_map(dispatch, out_placements=(pg, pe),
                         in_placements=(pg, pg), device_mesh=mesh,
                         redistribute_inputs=True)(xg, e_flat)
    if ep is None:
        out_buf = _experts(params, buf, act)
    else:
        pw = tuple(Shard(0) if i == ep else Replicate()
                   for i in range(mesh.ndim))
        out_buf = local_map(
            lambda buf, w1, w3, w2: _experts(
                {"w1": w1, "w3": w3, "w2": w2}, buf, act),
            out_placements=(pe,), in_placements=(pe, pw, pw, pw),
            device_mesh=mesh, redistribute_inputs=True)(
            buf, params["w1"], params["w3"], params["w2"])
    y = local_map(combine, out_placements=(tuple(py),),
                  in_placements=(pe, pg, pg, pg), device_mesh=mesh,
                  redistribute_inputs=True)(out_buf, e_flat, pos, w_flat)
    return shard_hint(y, "moe_out")


def moe_ffn_dense_reference(params, x, spec, act: str = "swiglu"):
    """Oracle: every token through its top-k experts, no capacity drops."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    logits = xf.to(F32) @ params["router"].to(F32)
    weights, idx = _route(logits, spec)
    h1 = torch.einsum("td,edf->tef", xf, params["w1"])
    if act == "swiglu":
        h = F.silu(h1) * torch.einsum("td,edf->tef", xf, params["w3"])
    else:
        h = F.gelu(h1, approximate="tanh")
    all_out = torch.einsum("tef,efd->ted", h, params["w2"])
    sel = torch.take_along_dim(all_out, idx[..., None], dim=1)  # [T,k,d]
    y = torch.sum(sel * weights[..., None].to(sel.dtype), dim=1)
    return y.reshape(B, S, d)


def load_balance_loss(logits, idx, spec):
    """Switch-style auxiliary load-balancing loss (fraction * probability)."""
    E = spec.n_experts
    probs = torch.softmax(logits.to(F32), dim=-1)        # [T, E]
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[..., 0], E).to(F32).mean(dim=0)   # top-1 assignment
    return E * torch.sum(me * ce)


def router_z_loss(logits):
    """ST-MoE router z-loss: penalizes large router logits (stability)."""
    z = torch.logsumexp(logits.to(F32), dim=-1)
    return torch.mean(torch.square(z))
