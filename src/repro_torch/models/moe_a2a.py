"""Expert-parallel MoE with an explicit all-to-all (counterpart of
``repro.models.moe_a2a``), in plain PyTorch over ``torch.distributed``.

Tokens shard over the FSDP axes and the `model` axis, experts over
`model`.  Each rank routes its own tokens, sends only the routed rows to
the rank that owns their expert with ``all_to_all_single`` over the mesh's
`model` group (equal splits: the reference's ``tiled=True``), runs its
experts' products locally and sends the outputs back the same way.

Semantics: capacity-dropped tokens contribute zero at both of the
reference's capacity stages: the per-destination send buffers (``cs`` rows
for each rank of `model`) and the per-expert receive buffers (``c2`` rows
for each local expert), with the same order of precedence (a stable sort
by destination, then by local expert).  With ample capacity the result
equals ``moe_ffn_dense_reference``.

The exchange is differentiable (``_AllToAll``: its backward is the same
all-to-all, which sends each gradient row back to the rank it came from).
Its transport is chosen once, from the group's backend: NCCL, and gloo
with CPU tensors, exchange the tensors as they are; gloo with CUDA tensors
(ranks that share one card: NCCL refuses two ranks on one device) copies
the buffers to the host and back on purpose (``transport``).  Plain
tensors that every rank holds whole enter and leave through
``_LocalBlock`` and ``_Gather``, whose collectives take the same
transport; DTensors through their own redistribution.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import axis_names, axis_size
from repro_torch.models.moe import _route

F32 = torch.float32


def transport(group, device) -> str:
    """"host" when the exchange copies its buffers to the host and back
    (gloo with CUDA tensors), else "direct"."""
    import torch.distributed as dist

    if torch.device(device).type == "cuda" and \
            dist.get_backend(group) == "gloo":
        return "host"
    return "direct"


def _exchange(x, group, via_host: bool):
    """all_to_all_single with equal splits over dim 0 of ``x``."""
    import torch.distributed as dist

    src = x.cpu() if via_host else x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if via_host else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, via_host):
        ctx.group, ctx.via_host = group, via_host
        return _exchange(x, group, via_host)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.via_host), None, None


def _sortable_dispatch(ids, n_buckets: int, cap: int):
    """Bucket row indices by ``ids`` (invalid = negative -> dropped).

    Returns (bucket, pos, order): row ``order[j]`` goes to position
    ``pos[j]`` of bucket ``bucket[j]``; ``pos >= cap`` (``cap`` for an
    invalid id) drops it."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    valid = ids_sorted >= 0
    safe = torch.where(valid, ids_sorted, 0)
    counts = torch.zeros(n_buckets, dtype=torch.int64, device=ids.device)
    counts.index_add_(0, safe, valid.to(torch.int64))
    starts = torch.cumsum(counts, 0) - counts
    # invalid ids sort first; valid entry j's bucket-relative position is its
    # sorted index minus the invalid prefix minus its bucket's start offset
    n_invalid = (~valid).sum()
    pos = torch.arange(n, device=ids.device) - n_invalid - starts[safe]
    pos = torch.where(valid, pos, cap)
    return ids_sorted, pos, order


def _scatter(rows, bucket, pos, n_buckets: int, cap: int, fill=0):
    """[n_buckets, cap, ...] holding ``rows[j]`` at (bucket[j], pos[j])
    where ``pos[j] < cap``, ``fill`` elsewhere (the reference's scatter
    with mode="drop").  Dropped rows land in an extra row ``cap`` that is
    cut off; the kept pairs are unique, so the write is exact."""
    buf = rows.new_full((n_buckets, cap + 1) + rows.shape[1:], fill)
    buf = buf.index_put((bucket.clamp(min=0), pos.clamp(max=cap)), rows)
    return buf[:, :cap]


def _experts(buf, w1, w3, w2, act: str):
    h1 = torch.einsum("ecd,edf->ecf", buf, w1)
    if act == "swiglu":
        h = F.silu(h1) * torch.einsum("ecd,edf->ecf", buf, w3)
    elif act == "geglu":
        h = F.gelu(h1, approximate="tanh") * torch.einsum("ecd,edf->ecf",
                                                          buf, w3)
    else:       # jax.nn.gelu's default: the tanh approximation
        h = F.gelu(h1, approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, w2)


def _moe_block(x_blk, router, w1, w3, w2, *, spec, act, tp_size, e_loc,
               shard, exchange):
    """One rank's block: x_blk [B_loc, S_loc, d]; router [d, E]; w1/w3
    [E_loc, d, f]; w2 [E_loc, f, d]; ``shard`` its index on `model`."""
    B_loc, S_loc, d = x_blk.shape
    T = B_loc * S_loc
    k = spec.top_k
    dev = x_blk.device
    xf = x_blk.reshape(T, d)

    # ---- local routing ---------------------------------------------------
    logits = xf.to(F32) @ router.to(F32)                  # [T, E]
    weights, idx = _route(logits, spec)                   # [T, k]
    e_flat = idx.reshape(-1)                              # [T*k]
    t_flat = torch.arange(T, device=dev).repeat_interleave(k)
    w_flat = weights.reshape(-1)

    # ---- pack per destination shard --------------------------------------
    cs = max(1, math.ceil(T * k * spec.capacity_factor / tp_size))
    dest = e_flat // e_loc
    dest_sorted, pos, order = _sortable_dispatch(dest, tp_size, cs)
    send_x = _scatter(xf[t_flat[order]], dest_sorted, pos, tp_size, cs)
    send_e = _scatter(e_flat[order], dest_sorted, pos, tp_size, cs, -1)

    # ---- all-to-all: rows travel to their expert's shard ------------------
    recv_x = exchange(send_x, True)
    recv_e = exchange(send_e, False)

    # ---- local dispatch to experts ----------------------------------------
    n_recv = tp_size * cs
    rx = recv_x.reshape(n_recv, d)
    re = recv_e.reshape(n_recv)
    le = torch.where(re >= 0, re - shard * e_loc, -1)     # local expert id
    c2 = max(1, math.ceil(n_recv / e_loc))
    le_sorted, pos2, order2 = _sortable_dispatch(le, e_loc, c2)
    buf = _scatter(rx[order2], le_sorted, pos2, e_loc, c2)

    # ---- expert FFN --------------------------------------------------------
    out_buf = _experts(buf, w1, w3, w2, act)

    # ---- local combine back into recv slot order --------------------------
    keep2 = (pos2 < c2) & (le_sorted >= 0)
    rows2 = out_buf[le_sorted.clamp(0, e_loc - 1), pos2.clamp(0, c2 - 1)]
    rows2 = rows2 * keep2[:, None].to(rows2.dtype)
    back = torch.zeros_like(rows2).index_copy(0, order2, rows2)
    back = back.reshape(tp_size, cs, d)

    # ---- all-to-all return trip + weighted combine ------------------------
    ret = exchange(back, True)
    keep = pos < cs
    rows = ret[dest_sorted.clamp(0, tp_size - 1), pos.clamp(0, cs - 1)]
    scale = torch.where(keep, w_flat[order], 0.0).to(rows.dtype)
    rows = rows * scale[:, None]
    y = torch.zeros((T, d), dtype=x_blk.dtype, device=dev).index_add(
        0, t_flat[order], rows)
    return y.reshape(B_loc, S_loc, d)


def _block_index(spec, mesh, coord, shape):
    """The slices of the block at mesh coordinate ``coord`` of a tensor of
    ``shape`` laid out as ``spec`` (even splits, names major first)."""
    names, sizes = axis_names(mesh), tuple(mesh.shape)
    index = []
    for dim, n_dim in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        if entry is None:
            index.append(slice(None))
            continue
        n, idx = 1, 0
        for a in ((entry,) if isinstance(entry, str) else entry):
            i = names.index(a)
            idx, n = idx * sizes[i] + coord[i], n * sizes[i]
        size = n_dim // n
        index.append(slice(idx * size, (idx + 1) * size))
    return tuple(index)


def _blocks(spec, mesh, shape):
    """Every rank's block index, in the order of global ranks."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if mesh.size() != world:
        raise ValueError("a plain tensor needs a mesh over every rank of "
                         "the process group")
    return [_block_index(spec, mesh, (mesh.mesh == r).nonzero()[0].tolist(),
                         shape) for r in range(world)]


def _all_reduce(t, via_host: bool):
    import torch.distributed as dist

    buf = t.cpu() if via_host else t
    dist.all_reduce(buf)
    return buf.to(t.device) if via_host else buf


class _LocalBlock(torch.autograd.Function):
    """This rank's block of a tensor every rank holds whole (the same
    values); in the backward each rank's block gradient is summed over
    the ranks into the whole, as each rank's tokens add their share."""

    @staticmethod
    def forward(ctx, t, index, via_host):
        ctx.shape, ctx.index, ctx.via_host = t.shape, index, via_host
        return t[index].contiguous()

    @staticmethod
    def backward(ctx, g):
        whole = g.new_zeros(ctx.shape)
        whole[ctx.index] = g
        return _all_reduce(whole, ctx.via_host), None, None


class _Gather(torch.autograd.Function):
    """The whole tensor from every rank's block; every rank then holds the
    same whole, so a block's gradient is its slice of the gradient."""

    @staticmethod
    def forward(ctx, blk, shape, indices, via_host):
        import torch.distributed as dist

        ctx.index = indices[dist.get_rank()]
        src = blk.detach().cpu() if via_host else blk.detach().contiguous()
        parts = [torch.empty_like(src) for _ in indices]
        dist.all_gather(parts, src)
        whole = src.new_empty(shape)
        for part, index in zip(parts, indices):
            whole[index] = part
        return whole.to(blk.device) if via_host else whole

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index].contiguous(), None, None, None


def _dtensor_block(t, mesh, spec):
    """This rank's block of the DTensor ``t`` under ``spec``; its gradient
    is partial (a sum over ranks) along the axes the spec replicates."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.launch.sharding import to_placements

    pl = to_placements(spec, mesh)
    grad_pl = [Partial() if isinstance(p, Replicate) else p for p in pl]
    return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)


def moe_ffn_a2a(params, x, spec, act, mesh, *, fsdp_axes, tp_axis="model"):
    """x [B, S, d] -> [B, S, d] with explicit expert-parallel all-to-all
    on ``mesh`` (a ``DeviceMesh``).

    ``x`` and each parameter are DTensors on ``mesh`` or plain tensors
    that every rank holds whole (the same values; the mesh then spans
    every rank).  A DTensor ``x`` gives a DTensor sharded as (fsdp, tp,
    None); a plain one the whole result on every rank, gathered over the
    transport of the exchange, and a plain tensor's gradient is summed
    over the ranks the same way.  Requires S % tp == 0, E % tp == 0,
    B % fsdp == 0; the caller falls back to ``moe_ffn`` otherwise.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import _spec, to_placements

    tp_size = axis_size(mesh, tp_axis)
    e_loc = spec.n_experts // tp_size
    x_spec = _spec(fsdp_axes, tp_axis, None)
    experts = _spec(tp_axis, None, None)
    group = mesh.get_group(tp_axis)
    via_host = transport(group, x.device) == "host"
    coord = mesh.get_coordinate()

    def block(t, spec):
        if isinstance(t, DTensor):
            return _dtensor_block(t, mesh, spec)
        return _LocalBlock.apply(t, _block_index(spec, mesh, coord, t.shape),
                                 via_host)

    def exchange(t, differentiable):
        if differentiable:
            return _AllToAll.apply(t, group, via_host)
        return _exchange(t, group, via_host)

    y = _moe_block(
        block(x, x_spec), block(params["router"].to(x.dtype), (None, None)),
        *(block(params[n], experts) for n in ("w1", "w3", "w2")),
        spec=spec, act=act, tp_size=tp_size, e_loc=e_loc,
        shard=mesh.get_local_rank(tp_axis), exchange=exchange)
    if isinstance(x, DTensor):
        return DTensor.from_local(y, mesh, to_placements(x_spec, mesh),
                                  run_check=False)
    return _Gather.apply(y, x.shape, _blocks(x_spec, mesh, x.shape),
                         via_host)


def a2a_applicable(x_shape, spec, mesh, tp_axis="model") -> bool:
    if mesh is None:
        return False
    tp = axis_size(mesh, tp_axis) if tp_axis in axis_names(mesh) else 1
    if tp <= 1:
        return False
    B, S, _ = x_shape
    return (S % tp == 0 and spec.n_experts % tp == 0
            and spec.n_experts >= tp)
