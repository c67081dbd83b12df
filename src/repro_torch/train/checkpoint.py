"""Checkpointing: atomic, keep-last-k, elastic (mesh-shape-agnostic), with
optional async save — the port of ``src/repro/train/checkpoint.py``, in
the reference's format.

Format: one directory per step, ``step_<n>/arrays.npz`` + ``meta.json``.
Arrays are stored by the reference's tree-path names with logical
shapes (``interop.named_leaves``: a NamedTuple by its field names, a
layer stack as the reference's stacked ``(L, ...)`` leaf), so a
checkpoint written by either package restores in the other, and one
written on one mesh restores onto any other (nothing in it depends on
the mesh). bfloat16 leaves are stored as float32 (numpy has no
bfloat16; the widening is exact) and cast back to the template's dtype
on restore. Writes go to a tmp dir then ``os.replace`` (atomic on
POSIX): a killed job never leaves a half-written step visible.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.interop import named_leaves, tree_unflatten


def _host(leaf) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Dict = None,
         keep: int = 3, async_save: bool = False):
    """Snapshot ``tree`` (a port tree of tensors: dicts, NamedTuples,
    per-layer lists) at ``step``. The arrays reach the host before this
    returns; with ``async_save`` the write runs on a thread, which is
    returned."""
    arrays = {}
    for leaf in named_leaves(tree):
        arrays[leaf.name] = (np.stack([_host(t) for t in leaf.tensors])
                             if leaf.stacked else _host(leaf.tensors[0]))
    meta = {"step": int(step), "extra": extra or {},
            "names": sorted(arrays)}

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)           # atomic publish
        _cleanup(ckpt_dir, keep)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _cleanup(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, *, step: int = None):
    """Restore into the structure of ``template`` (a port tree of
    tensors), each leaf in its template leaf's dtype and on its device.
    Raises on a missing leaf or a shape mismatch. Returns (tree, step,
    extra)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as npz:
        for leaf in named_leaves(template):
            if leaf.name not in npz:
                raise KeyError(f"checkpoint missing leaf {leaf.name}")
            arr = npz[leaf.name]
            first = leaf.tensors[0]
            want = ((len(leaf.tensors),) + tuple(first.shape)
                    if leaf.stacked else tuple(first.shape))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"shape mismatch for {leaf.name}: ckpt {arr.shape} vs "
                    f"template {want}")
            pieces = list(arr) if leaf.stacked else [arr]
            for piece, t in zip(pieces, leaf.tensors):
                out.append(torch.from_numpy(np.array(piece)).to(
                    device=t.device, dtype=t.dtype))
    return tree_unflatten(template, out), step, meta["extra"]
