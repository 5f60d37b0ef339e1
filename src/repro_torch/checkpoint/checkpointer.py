"""Checkpoint and restore with manifests and async save, after
``repro.checkpoint.checkpointer``, in the reference's on-disk layout.

Layout: ``<dir>/step_<N:08d>/leaf_<i>.npy`` + ``manifest.json``
recording each leaf's path, index, shape and dtype; written under
``.tmp_step_<N:08d>`` and renamed into place.  Leaves are named and
numbered as the reference's (``pytree.flatten``: ``.params/blocks/l0/ln1``,
``.opt/.mu/embed``, ``.opt/.step``), and a ``pytree.Leaf`` is written
stacked as the reference stacks it, so a checkpoint written by either
package restores in the other.  bfloat16 is stored as its raw ``uint16``
bits.  A mesh (``mesh_desc``, the reference's ``shardings``) has no
counterpart on one card.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..pytree import Leaf, flatten, from_numpy, to_numpy, tree_map

Tree = Any


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, logical dtype) of one leaf, fetched to the host."""
    if isinstance(leaf, Leaf):
        return leaf.numpy(), str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, torch.Tensor):
        return to_numpy(leaf), str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, (bool, int)) and not isinstance(leaf, np.generic):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str | Path, step: int, tree: Tree, *,
         mesh_desc: str = "", keep: int = 3, async_: bool = False) -> Path:
    """Write a checkpoint; returns its directory.  ``async_`` runs the file
    writes on a daemon thread (the arrays are first fetched to host)."""
    ckpt_dir = Path(ckpt_dir)
    out = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    flat = flatten(tree)
    host = [_host(leaf) for _, leaf in flat]

    def _write():
        tmp.mkdir(parents=True, exist_ok=True)
        manifest = {"step": step, "mesh": mesh_desc, "leaves": []}
        for i, ((name, _), (arr, dtype)) in enumerate(zip(flat, host)):
            np.save(tmp / f"leaf_{i}.npy", arr)
            manifest["leaves"].append({
                "index": i, "path": name, "shape": list(arr.shape),
                "dtype": dtype})
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f, indent=1)
        if out.exists():
            shutil.rmtree(out)
        tmp.rename(out)   # atomic publish
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        t.join(timeout=0)  # fire and forget; latest() ignores tmp dirs
    else:
        _write()
    return out


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest(ckpt_dir: str | Path) -> Optional[Path]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(p for p in ckpt_dir.glob("step_*")
                   if p.is_dir() and (p / "manifest.json").exists())
    return steps[-1] if steps else None


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, (Leaf, torch.Tensor, np.ndarray)):
        return tuple(leaf.shape)
    return ()


def restore(ckpt: str | Path, template: Tree) -> Tuple[int, Tree]:
    """Restore into the template's structure, each leaf in the template's
    dtype: a ``Leaf``'s parts are written in place (and the ``Leaf``
    returned), a tensor comes back as a new tensor on the template's
    device, a number as a number."""
    ckpt = Path(ckpt)
    with open(ckpt / "manifest.json") as f:
        manifest = json.load(f)
    by_path = {entry["path"]: entry for entry in manifest["leaves"]}
    loaded = []
    for name, tmpl in flatten(template):
        meta = by_path.get(name)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(ckpt / f"leaf_{meta['index']}.npy")
        if tuple(arr.shape) != _shape(tmpl):
            raise ValueError(f"{name}: shape {arr.shape} != {_shape(tmpl)}")
        loaded.append((arr, meta.get("dtype", "")))
    it = iter(loaded)             # tree_map visits the leaves in this order

    def one(tmpl):
        arr, dtype = next(it)
        if isinstance(tmpl, Leaf):
            if dtype == "bfloat16":
                arr = from_numpy(arr, torch.float32, "bfloat16").numpy()
            with torch.no_grad():
                tmpl.load_(arr)
            return tmpl
        if isinstance(tmpl, torch.Tensor):
            return from_numpy(arr, tmpl.dtype, dtype).to(tmpl.device)
        if isinstance(tmpl, np.ndarray):
            if dtype == "bfloat16":
                arr = from_numpy(arr, torch.float32, "bfloat16").numpy()
            return arr.astype(tmpl.dtype)
        return type(tmpl)(arr.item())

    return manifest["step"], tree_map(one, template)
