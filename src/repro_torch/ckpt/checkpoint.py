"""Atomic, async checkpoints of tensor trees; counterpart of
`repro.ckpt.checkpoint`, in the reference's on-disk layout.

Layout:  <dir>/step_<n>.tmp/...  -> atomic rename to <dir>/step_<n>/
  manifest.json   step, leaf count, the tree's structure, and each leaf's
                  dtype name and shape
  <idx>.npy       one file a leaf, in flatten order

A tree is a leaf (numpy array, tensor or scalar), or a list, tuple,
NamedTuple or dict of trees; dicts flatten in sorted key order and None
holds no leaf, as `jax.tree` flattens them, so the two packages number
the leaves of the same tree alike and read each other's directories.
Low-precision leaves (bfloat16, float8_e4m3fn, float8_e5m2) are stored
as their raw bits (uint16 or uint8) under their own dtype name, so
nothing beyond numpy and torch is needed to read them back.

`latest_step` picks the newest *committed* step: torn `.tmp` writes from
a killed writer, malformed names and manifests whose leaf files are
missing are skipped. `AsyncCheckpointer` copies the state to the host in
the caller's thread and writes it on a worker thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

#: dtype name -> (torch dtype, the numpy dtype of its raw bits on disk,
#: the same bits as a numpy dtype torch can wrap)
_BIT_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8),
}
_NAME_OF = {t: name for name, (t, _, _) in _BIT_DTYPES.items()}


def tree_leaves_with_paths(tree, path=()) -> list:
    """[(path, leaf)] in the reference's (jax.tree) order; a path is a
    tuple of dict keys and sequence indices."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in tree_leaves_with_paths(t, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    """The leaves of `tree` in the reference's (jax.tree) order."""
    return [x for _, x in tree_leaves_with_paths(tree)]


def _structure(tree) -> str:
    """A text form of the tree's structure, leaves as `*`."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(t) for t in tree)
        if isinstance(tree, list):
            return f"[{inner}]"
        return f"{type(tree).__name__}({inner})"
    return "*"


def tree_rebuild(like, leaves):
    """`like`'s structure with its leaves taken in `tree_leaves` order
    from the iterator `leaves` (dicts come back in sorted key order)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: tree_rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        items = [tree_rebuild(t, leaves) for t in like]
        if isinstance(like, list):
            return items
        return type(like)(*items) if hasattr(like, "_fields") else \
            tuple(items)
    return next(leaves)


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves (or None) of
    `rest`, keeping `tree`'s structure; a None in `tree` is a leaf here."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _host(leaf, allow_cuda: bool = True):
    """(numpy array, dtype name) of one leaf, copied to the host.
    `allow_cuda=False` refuses a tensor on a device: what may cross into
    a writer thread is host memory only."""
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type != "cpu" and not allow_cuda:
            raise TypeError(
                f"checkpoint leaf on {leaf.device}: an asynchronous save "
                f"takes host arrays only; copy the state to the host first")
        x = leaf.detach().cpu()
        if x.dtype in _NAME_OF:
            name = _NAME_OF[x.dtype]
            raw = x.view(torch.int16 if x.element_size() == 2
                         else torch.uint8)
            return raw.numpy().view(_BIT_DTYPES[name][1]).copy(), name
        return x.numpy().copy(), str(x.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_disk(arr: np.ndarray, name: str):
    """A loaded leaf in its manifest dtype: numpy, or for the
    low-precision dtypes a CPU tensor (numpy has no such dtype)."""
    if name in _BIT_DTYPES:
        t_dtype, _, readable = _BIT_DTYPES[name]
        raw = np.ascontiguousarray(arr.view(readable))
        return torch.from_numpy(raw).view(t_dtype)
    want = np.dtype(name)
    return arr if arr.dtype == want else arr.view(want)


def _write(directory: Path, step: int, structure: str, host) -> Path:
    """Write host leaves [(array, dtype name)] as step `step`, committed
    by one atomic rename."""
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step:08d}.tmp"
    final = directory / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    meta = {"step": step, "n_leaves": len(host), "treedef": structure,
            "leaves": []}
    for i, (arr, name) in enumerate(host):
        np.save(tmp / f"{i}.npy", arr)
        meta["leaves"].append({"dtype": name, "shape": list(arr.shape)})
    (tmp / "manifest.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)            # atomic commit
    return final


def save(directory, step: int, tree) -> Path:
    """Write `tree` as step `step` of `directory` (tensors on any device
    are copied to the host); returns the committed step directory."""
    return _write(Path(directory), step, _structure(tree),
                  [_host(x) for x in tree_leaves(tree)])


def _step_of(path: Path) -> Optional[int]:
    """A committed step directory's step; None for anything else (torn
    .tmp directories, stray files, malformed or non-canonical names)."""
    if not path.is_dir() or not path.name.startswith("step_") \
            or path.name.endswith(".tmp"):
        return None
    try:
        step = int(path.name.split("_", 1)[1])
    except ValueError:
        return None
    # only canonical names: steps are addressed as step_{n:08d}
    return step if path.name == f"step_{step:08d}" else None


def _is_committed(path: Path) -> bool:
    """A step directory is loadable iff its manifest parses and every leaf
    file it names exists: a resume must never pick a torn checkpoint."""
    try:
        meta = json.loads((path / "manifest.json").read_text())
    except (OSError, ValueError):
        return False
    n = meta.get("n_leaves")
    if not isinstance(n, int) or n < 0:
        return False
    return all((path / f"{i}.npy").exists() for i in range(n))


def latest_step(directory) -> Optional[int]:
    """The largest committed step in `directory`, or None. Candidates are
    verified newest first, so a missing or empty directory, torn writes,
    stray entries and manifests with missing leaves are all skipped."""
    directory = Path(directory)
    if not directory.exists():
        return None
    cands = sorted(((s, p) for p in directory.iterdir()
                    if (s := _step_of(p)) is not None), reverse=True)
    for step, path in cands:
        if _is_committed(path):
            return step
    return None


def load_leaves(directory, step: int) -> list:
    """A checkpoint's leaves in index order, without a like_tree: numpy
    arrays in their manifest dtype (bfloat16 and float8 leaves as CPU
    tensors). For self-describing state, which a fresh process restores
    before it knows the payload's structure."""
    directory = Path(directory) / f"step_{step:08d}"
    meta = json.loads((directory / "manifest.json").read_text())
    return [_from_disk(np.load(directory / f"{i}.npy"),
                       meta["leaves"][i]["dtype"])
            for i in range(meta["n_leaves"])]


def restore(directory, step: int, like_tree, *, device=None):
    """`like_tree`'s structure rebuilt from step `step`, every leaf a
    tensor on `device` (default the card) in its stored dtype."""
    from ..device import resolve_device
    dev = resolve_device(device)
    leaves = load_leaves(directory, step)
    n_like = len(tree_leaves(like_tree))
    if len(leaves) != n_like:
        raise ValueError(f"checkpoint holds {len(leaves)} leaves, the tree "
                         f"{n_like}")
    return tree_rebuild(like_tree, iter(torch.as_tensor(x).to(dev)
                                    for x in leaves))


def gc_old(directory, keep: int = 3):
    """Delete all but the newest `keep` committed step directories."""
    directory = Path(directory)
    if not directory.exists():
        return
    steps = sorted(p for p in directory.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


class AsyncCheckpointer:
    """Non-blocking save: the caller's thread copies the state to host
    numpy (a tensor on a device raises), a worker thread writes it and
    collects old steps. `wait` joins the write and re-raises its error."""

    def __init__(self, directory, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree):
        self.wait()
        structure = _structure(tree)
        host = [_host(x, allow_cuda=False) for x in tree_leaves(tree)]

        def work():
            try:
                _write(self.directory, step, structure, host)
                gc_old(self.directory, self.keep)
            except BaseException as err:   # re-raised by wait()
                self._error = err

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
