"""Checkpoints of trees of tensors: atomic, asynchronous, self-checking.

The port's counterpart of ``repro.checkpoint.manager``, writing and
reading the same on-disk format (format 2), so a snapshot moves between
the two packages:

* **Layout**: ``<path>/step_XXXXXXXX/`` holds ``arrays.npz`` (one array
  per leaf, keyed by the leaf's path in the tree: ``['state'].w``,
  ``['draws'][0]['lock']``, as ``jax.tree_util.keystr`` spells it) and
  ``manifest.json`` (step, time, the sorted keys, each leaf's shape and
  dtype, the caller's ``extra`` dict, ``"format": 2``).

* **Atomic**: a checkpoint is written to ``step_XXXXXXXX.tmp/``, both
  files are fsynced, and the directory is renamed to ``step_XXXXXXXX/``
  — a crash mid-write cannot corrupt the newest valid checkpoint.
  ``latest()`` ignores ``.tmp`` directories; ``gc_orphans=True`` (the
  manager's default) deletes them.

* **Async**: ``save_async`` copies the tree to the host (the only
  synchronous part), then writes on a daemon thread; ``wait()`` joins it
  before the next save (one save in flight).

* **Self-checking restore**: each candidate step is validated — the
  manifest against the array file, both against the target tree (leaf
  names and shapes). With ``step=None`` a corrupt newest step falls back
  to the previous valid one with a ``RuntimeWarning``; when every step
  fails, the oldest failure is raised as is.

* **Retention**: the newest ``keep`` checkpoints stay; older ones are
  deleted after a successful save.

Leaves are tensors (saved as numpy from any device, restored onto the
target leaf's device and dtype), numpy arrays or Python scalars; a tree
is made of dicts, lists, tuples and dataclasses (``NetworkState``).
Where the JAX manager re-shards a restore onto a device mesh, the port
has no mesh yet (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import warnings

import numpy as np
import torch

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _flatten(tree, prefix: str = "") -> list:
    """[(key, leaf)] in a fixed order, keys as ``jax.tree_util.keystr``
    spells them."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, f"{prefix}[{i}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in _flatten(getattr(tree, f.name),
                                   f"{prefix}.{f.name}")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _unflatten(tree, leaves: iter):
    """``tree``'s structure with its leaves taken in order from
    ``leaves``."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _unflatten(tree[k], leaves)
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    if tree is None:
        return None
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _host_tree(tree) -> dict:
    return {k: _to_host(v) for k, v in _flatten(tree)}


def save(path: str, tree, step: int, extra: dict | None = None) -> str:
    """Synchronous atomic checkpoint of a tree of tensors."""
    return _write(path, _host_tree(tree), step, extra or {})


def _fsync(name: str) -> None:
    fd = os.open(name, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(path: str, host: dict, step: int, extra: dict) -> str:
    os.makedirs(path, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(path, name + ".tmp")
    final = os.path.join(path, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _ARRAYS), **host)
    _fsync(os.path.join(tmp, _ARRAYS))
    manifest = {
        "step": step,
        "time": time.time(),
        "treedef": "repro_torch",
        "keys": sorted(host),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in host.items()},
        "extra": extra,
        "format": 2,
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _fsync(path)
    return final


def valid_steps(path: str) -> list[int]:
    """All published (non-``.tmp``, manifest-bearing) steps, ascending."""
    if not os.path.isdir(path):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(path, d, _MANIFEST)))


def _remove_orphans(path: str) -> None:
    for d in os.listdir(path):
        if d.startswith("step_") and d.endswith(".tmp"):
            shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest(path: str, *, gc_orphans: bool = False) -> int | None:
    """Newest published step (never a ``.tmp`` orphan).

    ``gc_orphans=True`` also deletes ``step_*.tmp/`` directories left by
    a crash mid-write; pass it only when no writer can be in flight
    (:class:`CheckpointManager` joins its worker first).
    """
    if not os.path.isdir(path):
        return None
    if gc_orphans:
        _remove_orphans(path)
    steps = valid_steps(path)
    return max(steps) if steps else None


def restore(path: str, target_tree, step: int | None = None):
    """Restore into the structure of ``target_tree``: each leaf comes
    back with the target leaf's dtype, a tensor on the target tensor's
    device. Returns ``(tree, step, extra)``.

    Every candidate checkpoint is validated (manifest parses, the array
    file loads, leaf names/shapes/dtypes match the manifest, names and
    shapes match the target). With ``step=None`` a corrupt newest
    checkpoint falls back to the previous valid one with a
    ``RuntimeWarning``; an explicit ``step`` raises.
    """
    if step is not None:
        return _load_checked(path, step, target_tree)
    candidates = valid_steps(path)
    if not candidates:
        raise FileNotFoundError(f"no checkpoint under {path}")
    for i, s in enumerate(reversed(candidates)):
        try:
            return _load_checked(path, s, target_tree)
        except Exception as e:                      # noqa: BLE001
            if i == len(candidates) - 1:
                # every candidate failed: a structural mismatch with the
                # target (KeyError / ValueError) is the caller's, and
                # keeps its type
                raise
            warnings.warn(
                f"checkpoint step {s} under {path} failed validation "
                f"({type(e).__name__}: {e}); falling back to the "
                "previous checkpoint", RuntimeWarning, stacklevel=2)


def _restored(arr: np.ndarray, tgt):
    if isinstance(tgt, torch.Tensor):
        return torch.as_tensor(arr).to(device=tgt.device, dtype=tgt.dtype)
    if isinstance(tgt, np.ndarray):
        return arr.astype(tgt.dtype)
    return type(tgt)(arr)


def _load_checked(path: str, step: int, target_tree):
    """Load one checkpoint, validating manifest vs arrays vs target."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    try:
        data = np.load(os.path.join(d, _ARRAYS))
        arrays = {k: data[k] for k in data.keys()}
    except Exception as e:
        raise ValueError(
            f"checkpoint step {step}: corrupt array file "
            f"({type(e).__name__}: {e})") from e
    spec = manifest.get("leaves")
    if spec is not None:                       # format >= 2 self-check
        if set(spec) != set(arrays):
            raise ValueError(
                f"checkpoint step {step}: manifest names "
                f"{sorted(set(spec) ^ set(arrays))} missing from one side")
        for k, meta in spec.items():
            arr = arrays[k]
            if (list(arr.shape) != meta["shape"]
                    or str(arr.dtype) != meta["dtype"]):
                raise ValueError(
                    f"checkpoint step {step}: leaf {k!r} is "
                    f"{arr.shape}/{arr.dtype}, manifest says "
                    f"{tuple(meta['shape'])}/{meta['dtype']}")
    out = []
    for key, tgt in _flatten(target_tree):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        want = tuple(getattr(tgt, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"target {want}")
        out.append(_restored(arr, tgt))
    tree = _unflatten(target_tree, iter(out))
    return tree, manifest["step"], manifest.get("extra", {})


class CheckpointManager:
    """Async manager with retention; one save in flight."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(path, exist_ok=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, tree, step: int, extra: dict | None = None):
        self.wait()
        host = _host_tree(tree)   # device -> host now; file IO on a thread

        def work():
            _write(self.path, host, step, extra or {})
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, tree, step: int, extra: dict | None = None) -> None:
        self.wait()
        save(self.path, tree, step, extra)
        self._gc()

    def latest(self) -> int | None:
        # join first: an in-flight save owns a live .tmp directory
        self.wait()
        return latest(self.path, gc_orphans=True)

    def restore(self, target_tree, step: int | None = None):
        self.wait()
        return restore(self.path, target_tree, step)

    def _gc(self) -> None:
        _remove_orphans(self.path)
        steps = valid_steps(self.path)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)
