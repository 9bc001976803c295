"""Checkpoint save/restore: atomic, retention-managed, in the JAX package's
file format (counterpart of ``repro.train.checkpoint``).

A checkpoint is ``step-XXXXXXXXX/arrays.npz`` + ``meta.json`` under the
checkpoint directory.  The npz keys are the leaves' paths as
``jax.tree_util.keystr`` writes them (``.params['blocks']['0']['mixer']
['wq']``, ``.opt.step``, ``.opt.m['embed']``): ``.name`` for a NamedTuple
field, ``[key!r]`` for a dict key.  bfloat16 is stored as float32 (npz
has no bfloat16; the cast is exact) and ``AdamWState.step``, a Python int
here, as the reference's 0-d int32, so a checkpoint written by either
package restores in the other.  Writes go to ``.tmp-step-N`` and are
published by one ``os.rename``, so a crash never leaves a torn checkpoint:
the restart path picks the latest complete step.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _items(tree, path=""):
    """(key, leaf) of every leaf of a tree of NamedTuples and dicts, the
    key as ``jax.tree_util.keystr`` gives it."""
    if _is_namedtuple(tree):
        for name in tree._fields:
            yield from _items(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(leaf, int):       # AdamWState.step: the reference's int32
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {key: _to_numpy(leaf) for key, leaf in _items(tree)}


# The write in flight, and the error it ended with; one caller thread (the
# train loop) starts and joins writes.
_async_state = {"thread": None, "error": None}


def save_checkpoint_async(ckpt_dir: str, step: int, state: Any,
                          extra: Optional[dict] = None, keep: int = 3):
    """Non-blocking checkpoint: the write, device-to-host copies included,
    happens on a background thread, so the train loop overlaps it with the
    next step.  At most one write is in flight; a new save joins the
    previous one first, and ``wait_pending_checkpoints`` raises its error.

    The thread reads ``state`` while the caller trains on.  That is a
    snapshot only because no train step writes into the tensors of the
    state it is given: AdamW returns new tensors every step
    (``train/optimizer.py``), as jax arrays are immutable in the
    reference.  An optimizer that updates in place would break this.  The
    copies run on the thread's default stream, after the work that made
    the state."""
    wait_pending_checkpoints()

    def write():
        try:
            save_checkpoint(ckpt_dir, step, state, extra, keep)
        except Exception as e:      # raised again by wait_pending_checkpoints
            _async_state["error"] = e

    t = threading.Thread(target=write, daemon=True)
    _async_state["thread"] = t
    t.start()
    return t


def wait_pending_checkpoints():
    """Join the write in flight, if any; raise the error it ended with."""
    t, _async_state["thread"] = _async_state["thread"], None
    if t is not None:
        t.join()
    err, _async_state["error"] = _async_state["error"], None
    if err is not None:
        raise err


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    extra: Optional[dict] = None, keep: int = 3):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-step-{step}")
    final = os.path.join(ckpt_dir, f"step-{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **_flatten(state))
    meta = {"step": step, **(extra or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _apply_retention(ckpt_dir, keep)


def _apply_retention(ckpt_dir: str, keep: int):
    steps = sorted(list_checkpoints(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step-{s:09d}"),
                      ignore_errors=True)


def list_checkpoints(ckpt_dir: str):
    """The steps of the complete checkpoints; torn ``.tmp-*`` writes are
    not among them."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step-") and not name.startswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
                out.append(int(name.split("-")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, state_template: Any,
                       shardings=None, device="cuda"):
    """Restore into the structure of ``state_template`` on ``device``;
    optionally re-shard with a matching tree of
    ``launch.sharding.NamedSharding`` (elastic re-meshing): each tensor
    leaf then comes back as a ``DTensor`` placed on its sharding's
    ``DeviceMesh`` by ``distribute_tensor``.

    Each tensor of the template gives its leaf's shape and dtype only, so
    the template may live on the ``meta`` device (``init_train_state_shape``);
    a Python number of the template (``AdamWState.step``) comes back as one.
    Raises ``KeyError`` for a leaf the file lacks and ``ValueError`` for a
    shape that differs.  Returns (state, meta)."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step-{step:09d}")
    with np.load(os.path.join(path, "arrays.npz")) as zf:
        arrays = {k: zf[k] for k in zf.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    def build(node, key):
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, name), f"{key}.{name}")
                                for name in node._fields))
        if isinstance(node, dict):
            return {k: build(v, f"{key}[{k!r}]") for k, v in node.items()}
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        arr = arrays[key]
        shape = tuple(node.shape) if isinstance(node, torch.Tensor) else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{shape}")
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(arr).to(device=dev, dtype=node.dtype)
        return type(node)(arr)

    state = build(state_template, "")
    if shardings is not None:
        state = _place(state, shardings)
    return state, meta


def _place(node, sharding):
    """``node`` with each tensor leaf distributed as its ``sharding`` says
    (the matching leaf of a tree laid out as ``node``)."""
    if _is_namedtuple(node):
        return type(node)(*(_place(getattr(node, f), getattr(sharding, f))
                            for f in node._fields))
    if isinstance(node, dict):
        return {k: _place(v, sharding[k]) for k, v in node.items()}
    if not isinstance(node, torch.Tensor):
        return node
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(node, sharding.mesh, sharding.placements)
