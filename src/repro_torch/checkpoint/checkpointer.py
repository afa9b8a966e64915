"""Asynchronous, restart-safe checkpointing of dicts of tensors.

The JAX package's on-disk layout, file for file: ``<dir>/step_<N>/``
holding one ``.npy`` per leaf plus a ``manifest.json`` with each leaf's
key path (``params/w0``, ``opt/m/w0``, ...; dict keys in sorted order,
list items by index, as ``jax.tree_util`` flattens), file name, dtype
string and shape.  So a checkpoint written by either package restores
in the other, bit for bit.  Low-precision floats are stored as
same-width unsigned integer views (``bfloat16`` as ``uint16``), made
with ``torch`` views.

Writes go to ``step_<N>.tmp`` and are renamed into place, so a crash
mid-save never corrupts the restore path: ``restore_latest`` only
considers directories with a manifest.  ``keep_last`` garbage-collects
older steps after a successful save.

* **Async**: ``AsyncCheckpointer.save`` takes an independent host copy
  of every leaf before it returns (``tensor.cpu()`` would hand back the
  SAME tensor for a CPU tensor, which an in-place update could change
  while the writer thread still reads it) and writes on a background
  thread.
* **Placement on restore**: ``restore(..., device=...)`` puts every leaf
  on one device; by default each leaf goes where the matching leaf of
  ``tree_like`` lives (the running job's state), a non-tensor leaf to
  the CPU.  The JAX package's ``shardings=`` has no counterpart: the
  port drives one device per process.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.adamw import tree_leaves, tree_unflatten

_MANIFEST = "manifest.json"

# numpy can't hold these natively; stored via same-width integer views
_VIEW_CONTAINERS = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_BY_TORCH_DTYPE = {v[0]: k for k, v in _VIEW_CONTAINERS.items()}


def _to_savable(leaf: Any) -> tuple[np.ndarray, str]:
    """(array np.save writes, dtype string of the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _BY_TORCH_DTYPE.get(t.dtype)
        if name is not None:
            _, view, container = _VIEW_CONTAINERS[name]
            return t.view(view).numpy().view(container), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_saved(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    if dtype_str in _VIEW_CONTAINERS:
        dtype, view, _ = _VIEW_CONTAINERS[dtype_str]
        return torch.from_numpy(arr.view(np.dtype(str(view)[6:]))
                                ).view(dtype)
    return torch.from_numpy(arr)


def _flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten_with_paths(
            tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in _flatten_with_paths(
            t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def save(ckpt_dir: str, step: int, tree: Any, *, keep_last: int = 3) -> str:
    """Blocking save. Returns the final checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = []
    for key, leaf in _flatten_with_paths(tree):
        savable, dtype_str = _to_savable(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), savable)
        names.append({"key": key, "file": fname, "dtype": dtype_str,
                      "shape": list(savable.shape)})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({"step": step, "leaves": names}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
                out.append(int(name[5:]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree_like: Any, *,
            device: "torch.device | str | None" = None) -> Any:
    """Restore into the structure of ``tree_like`` as tensors: on
    ``device`` if given, else each where ``tree_like``'s matching leaf
    lives (the CPU for a leaf that is not a tensor)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    out = []
    for key, like in _flatten_with_paths(tree_like):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint at {path} missing leaf {key!r}")
        t = _from_saved(np.load(os.path.join(path, entry["file"])),
                        entry["dtype"])
        where = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        out.append(t.to(where))
    return tree_unflatten(tree_like, out)


def restore_latest(ckpt_dir: str, tree_like: Any, *,
                   device: "torch.device | str | None" = None
                   ) -> tuple[Optional[int], Any]:
    step = latest_step(ckpt_dir)
    if step is None:
        return None, tree_like
    return step, restore(ckpt_dir, step, tree_like, device=device)


def host_copy(tree: Any) -> Any:
    """An independent CPU copy of every tensor leaf (numpy arrays are
    copied too), in ``tree``'s structure."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return np.array(x, copy=True)
    return tree_unflatten(tree, [copy(x) for x in tree_leaves(tree)])


class AsyncCheckpointer:
    """Background-thread checkpoint writer (one in flight at a time)."""

    def __init__(self, ckpt_dir: str, *, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()  # one in flight; also surfaces prior errors
        host_tree = host_copy(tree)

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree, keep_last=self.keep_last)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name=f"ckpt-save-{step}")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
