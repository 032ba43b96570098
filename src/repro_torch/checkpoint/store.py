"""Step-directory checkpoints of nested lists and dicts of arrays.

Layout: one directory per step with a JSON manifest (structure, dtypes,
shapes) plus one .npy per leaf. Writes go to a tmp dir and are then renamed
into place, so a crashed writer never corrupts the latest checkpoint; a
killed writer's leftover tmp dir is removed by the next save or restore.
``AsyncCheckpointer`` runs serialisation on a worker thread, so the caller
blocks only on the device-to-host copies.

A tree is nested dicts (flattened in sorted key order), lists and tuples
(in order) whose leaves are numpy arrays, torch tensors (copied to the
host through ``.cpu()``) or scalars; ``None`` holds no leaf. That is the
leaf order of ``jax.tree_util`` for the same nesting, so a checkpoint of
the JAX package's ``repro.checkpoint.store`` and one of this module hold
the same leaves in the same files. ``restore`` puts each leaf back where
the template's leaf lies: a tensor on its device and dtype, anything else
as a host array. A copy of ``repro.checkpoint.store`` without JAX.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

MANIFEST = "manifest.json"
_NUMPY_SAFE = {"float64", "float32", "float16", "int64", "int32", "int16",
               "int8", "uint64", "uint32", "uint16", "uint8", "bool"}


def _flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, structure): the leaves in ``jax.tree_util`` order and a
    JSON-able description of the nesting they came from."""
    leaves: list = []

    def walk(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return {"dict": [[k, walk(node[k])] for k in keys]}
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return {kind: [walk(v) for v in node]}
        leaves.append(node)
        return "*"

    return leaves, walk(tree)


def _unflatten(structure: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(node: Any) -> Any:
        if node is None:
            return None
        if node == "*":
            return next(it)
        if "dict" in node:
            return {k: build(v) for k, v in node["dict"]}
        if "list" in node:
            return [build(v) for v in node["list"]]
        return tuple(build(v) for v in node["tuple"])

    return build(structure)


def _host_array(leaf: Any) -> tuple[np.ndarray, str]:
    """(array to store, logical dtype name). A tensor of a dtype numpy
    cannot hold (bfloat16, float8) is stored widened to float32 and named
    by its torch dtype, so a restore casts it back."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        logical = str(t.dtype).removeprefix("torch.")
        if logical not in _NUMPY_SAFE:
            t = t.to(torch.float32)
        return t.numpy(), logical
    arr = np.asarray(leaf)
    logical = str(arr.dtype)
    if logical not in _NUMPY_SAFE:
        arr = arr.astype(np.float32)
    return arr, logical


def _clean_stale_tmp(root: Path) -> int:
    """Remove leftover ``.tmp_step_*`` dirs from killed writers. A tmp dir
    only exists while a save is in flight; any found at the start of a
    save/restore belongs to a writer that died mid-write and would otherwise
    poison the directory forever (the atomic rename never happened)."""
    removed = 0
    if root.exists():
        for stale in root.glob(".tmp_step_*"):
            shutil.rmtree(stale, ignore_errors=True)
            removed += 1
    return removed


def save(path: str | Path, step: int, tree: Any, *, keep: int = 3) -> Path:
    """Blocking save. Returns the final checkpoint dir."""
    root = Path(path)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}"
    _clean_stale_tmp(root)
    tmp.mkdir(parents=True)

    leaves, structure = _flatten(tree)
    meta = {"step": step, "treedef": json.dumps(structure),
            "num_leaves": len(leaves), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, logical = _host_array(leaf)
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
        meta["leaves"].append({"shape": list(arr.shape), "dtype": logical})
    (tmp / MANIFEST).write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(root, keep)
    return final


def latest_step(path: str | Path) -> int | None:
    root = Path(path)
    if not root.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in root.glob("step_*"))
    return steps[-1] if steps else None


def _step_dir(root: Path, step: int | None) -> tuple[int, Path]:
    _clean_stale_tmp(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    return step, root / f"step_{step:08d}"


def restore(path: str | Path, step: int | None, like: Any) -> tuple[int, Any]:
    """Load a checkpoint into the structure of ``like`` (validating leaf
    count and shapes). A leaf whose template is a tensor comes back as a
    tensor of the template's dtype on the template's device; any other
    leaf as a host array of the stored dtype."""
    step, d = _step_dir(Path(path), step)
    meta = json.loads((d / MANIFEST).read_text())
    like_leaves, structure = _flatten(like)
    if meta["num_leaves"] != len(like_leaves):
        raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, "
                         f"expected {len(like_leaves)}")
    out = []
    for i, ref in enumerate(like_leaves):
        arr = np.load(d / f"leaf_{i:05d}.npy")
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(np.shape(ref))}")
        if isinstance(ref, torch.Tensor):
            out.append(torch.from_numpy(arr).to(device=ref.device,
                                                dtype=ref.dtype))
        else:
            out.append(arr.astype(np.asarray(ref).dtype, copy=False))
    return step, _unflatten(structure, out)


def restore_list(path: str | Path, step: int | None = None
                 ) -> tuple[int, list[np.ndarray]]:
    """Load a checkpoint's leaves as a flat host-array list, structure-free.

    Unlike :func:`restore` this needs no ``like`` tree — the manifest alone
    drives the load (shape check + cast back per logical dtype). The
    serving WAL snapshots use it: their leaf count varies with the live job
    set, so no static template exists at recovery time.
    """
    step, d = _step_dir(Path(path), step)
    meta = json.loads((d / MANIFEST).read_text())
    out: list[np.ndarray] = []
    for i, leaf_meta in enumerate(meta["leaves"]):
        arr = np.load(d / f"leaf_{i:05d}.npy")
        if tuple(arr.shape) != tuple(leaf_meta["shape"]):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                             f"manifest shape {tuple(leaf_meta['shape'])}")
        logical = leaf_meta["dtype"]
        if logical in _NUMPY_SAFE and str(arr.dtype) != logical:
            arr = arr.astype(logical)
        out.append(arr)
    return step, out


def _gc(root: Path, keep: int) -> None:
    steps = sorted(root.glob("step_*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread (one in flight at a time —
    a second save waits, which back-pressures rather than queueing RAM)."""

    def __init__(self, path: str | Path, keep: int = 3):
        self.path = Path(path)
        self.keep = keep
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # the device-to-host copies happen here, before the caller goes on
        # and may overwrite the tensors; the worker only writes files
        leaves, structure = _flatten(tree)
        host_tree = _unflatten(structure,
                               [leaf.detach().cpu().clone()
                                if isinstance(leaf, torch.Tensor)
                                else np.array(leaf) for leaf in leaves])

        def work():
            try:
                save(self.path, step, host_tree, keep=self.keep)
            except Exception as e:      # noqa: BLE001
                self.last_error = e

        with self._lock:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
        if self.last_error is not None:
            raise self.last_error
