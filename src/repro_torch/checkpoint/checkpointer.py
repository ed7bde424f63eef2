"""Checkpointing designed for restart (counterpart of
``repro.checkpoint.checkpointer``), in the reference's on-disk layout, so
state carries across the two packages in both directions:

- **atomic commit**: writes land in ``<dir>/tmp.<step>.<pid>``, are
  fsynced, then the directory is renamed to ``step_<N>`` (``%08d``) and
  ``LATEST`` is replaced via atomic rename — a crash can never leave a
  half-readable "latest";
- **async**: ``Checkpointer.save_async`` copies every leaf to host memory
  on the caller's thread (the only synchronous part) and hands
  serialisation + IO to a writer thread.  The copy must happen before it
  returns: the solver's ``make_evolve`` overwrites its carry buffers in
  place, so a reference handed to the writer would be corrupted by the
  next chunk;
- **layout**: one ``.npy`` per leaf under a tree-path key plus a JSON
  manifest (``step``, ``time``, ``leaves{key: file, shape, dtype}``,
  ``metadata``).  Leaf keys are the reference's: nested dicts, lists and
  tuples flattened as jax flattens them (dict keys sorted), the path's
  parts joined with ``.``; bfloat16 leaves are stored as the reference
  stores them, two-byte void records with dtype name ``bfloat16``;
- **restore** onto each template leaf's device, into fresh tensors; with
  ``shardings`` (a :class:`~repro_torch.core.domain.DomainDecomposition`
  a leaf), each rank keeps its block of the leaf as a DTensor: leaves are
  stored whole, so a checkpoint restores onto a mesh of any shape (the
  elastic rescale).  A DTensor leaf is saved whole, gathered on every
  rank, and written by rank 0;
- **retention**: keep-last-k plus keep-best-by-metric.

The commit fires the chaos site ``checkpoint.write`` at its three
transitions (``point='leaves'``, ``'rename'``, ``'latest'``), as the
reference's does.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.runtime import chaos as _chaos
from repro_torch.util import tree_map

_MANIFEST = "manifest.json"
_LATEST = "LATEST"


def _flatten(tree: Any, path: tuple = ()) -> list[tuple[str, Any]]:
    """``[(key, leaf)]`` in jax's order: dict keys sorted, sequences by
    index, ``None`` an empty subtree; the key is the path joined by ``.``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (str(i),))]
    if tree is None:
        return []
    return [(".".join(path), tree)]


def _zip_up_to(tree: Any, other: Any) -> list:
    """``other``'s entry for each leaf of ``tree``, in :func:`_flatten`'s
    order; a leaf of ``other`` (None included) stands for the whole subtree
    of ``tree`` at its place."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _zip_up_to(
            tree[k], other[k] if isinstance(other, dict) else other)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _zip_up_to(
            v, other[i] if isinstance(other, (list, tuple)) else other)]
    return [] if tree is None else [other]


def _to_numpy(leaf: Any, *, copy: bool = False) -> np.ndarray:
    """A leaf on the host as a numpy array (a copy when ``copy``, which a
    tensor on the card always is).  A bfloat16 tensor becomes two-byte
    void records, as numpy holds the reference's bfloat16.  A DTensor is
    gathered whole (a collective: every rank of its mesh calls this)."""
    if isinstance(leaf, DTensor):
        from repro_torch.core.domain import gather

        leaf, copy = gather(leaf), True
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_pytree(
    tree: Any,
    directory: str,
    step: int,
    *,
    metadata: dict | None = None,
) -> str:
    """Synchronous atomic save of a tree of tensors or arrays.  Returns the
    committed directory.  A tree with DTensor leaves is a collective: every
    rank gathers them, rank 0 writes, and every rank returns once it
    committed, or raises if its commit failed."""
    leaves = _flatten(tree)
    if not any(isinstance(leaf, DTensor) for _, leaf in leaves):
        return _write(leaves, directory, step, metadata)
    arrays = [(key, _to_numpy(leaf)) for key, leaf in leaves]
    err = None
    if dist.get_rank() == 0:
        try:
            _write(arrays, directory, step, metadata)
        except BaseException as e:  # re-raised below, after telling the others
            err = e
    status = [None if err is None else repr(err)]
    dist.broadcast_object_list(status, src=0)
    if err is not None:
        raise err
    if status[0] is not None:
        raise RuntimeError(f"rank 0 failed to commit step {step}: {status[0]}")
    return os.path.join(directory, f"step_{step:08d}")


def _write(leaves: list, directory: str, step: int,
           metadata: dict | None) -> str:
    """The atomic commit of :func:`save_pytree` of ``[(key, leaf)]``."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    index = {}
    for key, leaf in leaves:
        arr = _to_numpy(leaf)
        fname = key.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        index[key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": _dtype_name(arr),
        }
    # chaos points name every commit transition, so the crash-consistency
    # sweep can kill the writer at each one and assert readers still see
    # a fully committed checkpoint (the previous one, or — after the
    # 'latest' point's rename — the new one).
    _chaos.fire("checkpoint.write", step=step, point="leaves")
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": index,
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    _chaos.fire("checkpoint.write", step=step, point="rename")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)
    _chaos.fire("checkpoint.write", step=step, point="latest")
    # atomic LATEST update
    lat_tmp = os.path.join(directory, _LATEST + ".tmp")
    with open(lat_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.rename(lat_tmp, os.path.join(directory, _LATEST))
    return final


def latest_step(directory: str) -> int | None:
    try:
        with open(os.path.join(directory, _LATEST)) as f:
            name = f.read().strip()
        return int(name.split("_")[-1])
    except (FileNotFoundError, ValueError):
        return None


def _leaf_tensor(arr: np.ndarray, dtype_name: str, like: Any,
                 dd: Any = None) -> torch.Tensor:
    """A fresh tensor of ``arr`` on the device of the template leaf ``like``
    (the host when it is not a tensor; the mesh's device for a ``meta``
    leaf); with a decomposition ``dd``, this rank's block of it as a
    DTensor laid out as ``dd.field_sharding()``."""
    if arr.dtype.kind == "V":
        if dtype_name != "bfloat16":
            raise ValueError(f"cannot restore a {dtype_name!r} leaf")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dd is not None:
        from repro_torch.core.domain import from_block, to_block

        placements = dd.field_sharding()
        block = to_block(t, dd.mesh, placements)
        device = like.to_local().device if isinstance(like, DTensor) else (
            like.device if isinstance(like, torch.Tensor) else block.device)
        if device.type == "meta":
            device = torch.device(dd.mesh.device_type)
        return from_block(block.to(device, copy=True), dd.mesh, placements,
                          t.shape)
    if isinstance(like, DTensor):  # back to the template's layout
        from torch.distributed.tensor import Replicate

        mesh = like.device_mesh
        t = t.to(like.to_local().device, copy=True)
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(
            mesh, like.placements)
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
    return t


def restore_pytree(
    template: Any,
    directory: str,
    *,
    step: int | None = None,
    shardings: Any = None,
) -> tuple[Any, dict]:
    """Restore into the structure of ``template``: ``(tree, manifest)``.

    Each leaf is a new tensor, of the checkpoint's dtype, on the device of
    the template's leaf (the host for a leaf that is not a tensor); no
    restored tensor shares memory with another or with the template.
    ``shardings`` (a tree of the template's structure, or one entry for a
    whole subtree) gives a leaf a
    :class:`~repro_torch.core.domain.DomainDecomposition`: the leaf comes
    back as a DTensor holding this rank's block, for the current mesh
    whatever the mesh that saved it (leaves are stored whole).  A DTensor
    leaf of the template without an entry there comes back as a DTensor
    of the template leaf's mesh and placements."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)

    leaves = []
    for (key, leaf), dd in zip(_flatten(template),
                               _zip_up_to(template, shardings), strict=True):
        info = manifest["leaves"].get(key)
        if info is None:
            raise KeyError(f"leaf {key!r} missing from checkpoint {d}")
        arr = np.load(os.path.join(d, info["file"]))
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs template "
                f"{shape}"
            )
        leaves.append(_leaf_tensor(arr, info["dtype"], leaf, dd))
    it = iter(leaves)
    return tree_map(lambda _: next(it), template), manifest


class Checkpointer:
    """Async checkpoint manager with retention policies."""

    def __init__(
        self,
        directory: str,
        *,
        keep_last: int = 3,
        keep_best: int = 0,
        best_metric: str = "loss",
        best_mode: str = "min",
    ):
        self.directory = directory
        self.keep_last = keep_last
        self.keep_best = keep_best
        self.best_metric = best_metric
        self.best_mode = best_mode
        self._q: "queue.Queue" = queue.Queue()
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- async API -----------------------------------------------------------
    def save_async(self, tree: Any, step: int, metadata: dict | None = None):
        """Copy every leaf to host memory now, on the caller's thread; write
        in the background."""
        host_tree = tree_map(lambda x: _to_numpy(x, copy=True), tree)
        self._q.put(("save", host_tree, step, metadata))

    def wait(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        self.wait()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                _, tree, step, metadata = item
                save_pytree(tree, self.directory, step, metadata=metadata)
                self._gc()
            except BaseException as e:  # surfaced on wait()
                self._err = e
            finally:
                self._q.task_done()

    def prune(self):
        """Apply the retention policy now (after a save made elsewhere,
        such as a collective :func:`save_pytree` of DTensors)."""
        self._gc()

    # -- retention -------------------------------------------------------------
    def _all_steps(self):
        steps = []
        if not os.path.isdir(self.directory):
            return steps
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                steps.append(int(name.split("_")[-1]))
        return sorted(steps)

    def _metric_of(self, step: int):
        try:
            with open(
                os.path.join(self.directory, f"step_{step:08d}", _MANIFEST)
            ) as f:
                return json.load(f)["metadata"].get(self.best_metric)
        except (OSError, ValueError, KeyError):
            return None  # unreadable/corrupt manifest: unscored, not fatal

    def _gc(self):
        steps = self._all_steps()
        keep = set(steps[-self.keep_last :]) if self.keep_last else set()
        if self.keep_best:
            scored = [
                (s, m) for s in steps if (m := self._metric_of(s)) is not None
            ]
            rev = self.best_mode == "max"
            scored.sort(key=lambda t: t[1], reverse=rev)
            keep |= {s for s, _ in scored[: self.keep_best]}
        for s in steps:
            if s not in keep:
                shutil.rmtree(
                    os.path.join(self.directory, f"step_{s:08d}"),
                    ignore_errors=True,
                )
