"""Checkpointing: a param tree -> ``arrays.npz`` + ``meta.json`` (twin of
``repro.checkpoint.ckpt``, in the reference's on-disk format, so a
checkpoint either package writes loads in the other).

  * one folder a step, ``step_{step:012d}/``, holding ``arrays.npz`` keyed
    by the ``|``-joined key-path parts of each leaf
    (``core.treepath.path_parts``: ``layers|0|attn|wq``, ``1|m|embed``)
    and ``meta.json`` (step, time, ``extra``, leaf count);
  * atomic writes (a temporary folder renamed into place), so a killed
    save never corrupts the latest checkpoint; step-based retention
    (``keep``); ``latest_step`` for restarts;
  * ``CheckpointManager``: the device-to-host copies on the caller's
    thread, the file work on a background thread.

A bfloat16 leaf is written as the reference's file holds one (numpy has
no bfloat16: its two bytes a value as ``|V2``) and read back bit for bit;
float32, int32 and the other numpy dtypes are written as they are.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.treepath import (path_parts, tree_flatten_with_path,
                                       tree_map, tree_unflatten_like)

Pytree = Any
_SEP = "|"
#: how the reference's ``np.savez`` stores a bfloat16 array
BF16_FILE_DTYPE = np.dtype("V2")


def _key_of(path) -> str:
    return _SEP.join(path_parts(path))


def _to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array the file holds (bfloat16 as ``|V2``)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_FILE_DTYPE)
    return t.numpy()


def _from_file(arr: np.ndarray, like) -> Any:
    """A stored array as a tensor on the template leaf's device (``|V2``
    as bfloat16); the array itself for a template leaf that is no
    tensor."""
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype == BF16_FILE_DTYPE:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(like.device)


def _flatten(tree: Pytree) -> Dict[str, np.ndarray]:
    return {_key_of(path): _to_host(leaf)
            for path, leaf in tree_flatten_with_path(tree)}


def _unflatten_into(template: Pytree, flat: Dict[str, np.ndarray]
                    ) -> Pytree:
    def leaf(path, like):
        key = _key_of(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if hasattr(like, "shape") and tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        return _from_file(arr, like)
    return tree_unflatten_like(template, leaf)


def save_checkpoint(directory: str, step: int, tree: Pytree,
                    extra: Optional[Dict] = None, keep: int = 3):
    """Atomic synchronous save."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}_{os.getpid()}")
    final = os.path.join(directory, f"step_{step:012d}")
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "time": time.time(),
                   "extra": extra or {}, "n_leaves": len(flat)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(directory, keep)
    return final


def _retain(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def load_checkpoint(directory: str, template: Pytree,
                    step: Optional[int] = None) -> Tuple[Pytree, Dict]:
    """(the tree of ``template``'s structure, its leaves the stored arrays
    as tensors on the template leaves' devices, in the stored dtypes;
    the meta dict).  A missing leaf raises ``KeyError``, a leaf of
    another shape ``ValueError``, each naming the leaf."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:012d}")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return _unflatten_into(template, flat), meta


class CheckpointManager:
    """Async checkpointing: device-to-host on the caller's thread, file IO
    off-thread.

    ``save`` returns once the leaves are on the host; ``wait`` blocks
    until the last save landed (called before exit and before a restore
    after a failure) and raises what it raised."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Pytree, extra: Optional[Dict] = None):
        self.wait()
        host_tree = tree_map(_to_host, tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra,
                                self.keep)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template: Pytree, step: Optional[int] = None):
        self.wait()
        return load_checkpoint(self.directory, template, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)


class ShardedCheckpointManager(CheckpointManager):
    """A world's checkpoints in the single-process format: each leaf the
    whole (global) array, so one process, another mesh or the JAX
    package restores them.

    ``specs``: the spec tree of the state (``launch.shardings``), whose
    leaves each rank holds as its blocks over ``mesh``.  ``save``
    all-gathers every leaf (every rank calls it), then rank 0 writes,
    off-thread as its parent does; ``latest_step`` and ``restore`` first
    wait for rank 0's last write (a barrier of the world), then every
    rank reads the whole arrays and keeps its blocks."""

    def __init__(self, directory: str, specs: Pytree, mesh, keep: int = 3):
        super().__init__(directory, keep)
        self.specs, self.mesh = specs, mesh

    def save(self, step: int, tree: Pytree, extra: Optional[Dict] = None):
        from repro_torch.launch.shardings import gather_tree
        full = gather_tree(tree, self.specs, self.mesh)
        if self.mesh.rank == 0:
            super().save(step, full, extra)

    def _settle(self):
        import torch.distributed as dist
        self.wait()
        if self.mesh.size > 1:
            dist.barrier()

    def latest_step(self) -> Optional[int]:
        self._settle()
        return latest_step(self.directory)

    def restore(self, template: Pytree, step: Optional[int] = None):
        """(the rank's blocks of the stored state, on the template
        leaves' devices in the stored dtypes; the meta dict)."""
        from repro_torch.distributed.sharding import _is_spec
        from repro_torch.launch.shardings import global_shape, local_shard
        self._settle()
        step = latest_step(self.directory) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:012d}")
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        specs = {_key_of(p): s for p, s in tree_flatten_with_path(
            self.specs, is_leaf=_is_spec)}

        def leaf(path, like):
            key = _key_of(path)
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            want = global_shape(like.shape, specs[key], self.mesh)
            if tuple(flat[key].shape) != want:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{flat[key].shape} vs {want}")
            whole = _from_file(flat[key], torch.empty(0))
            return local_shard(whole, specs[key], self.mesh) \
                .contiguous().to(like.device)

        return tree_unflatten_like(template, leaf), meta
