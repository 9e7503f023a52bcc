"""Atomic keep-k checkpoints in the reference's layout (its
``checkpoint/ckpt.py``), so that a checkpoint written by either side
restores on the other.

Layout (one directory per step):

    <dir>/step_000000123/
        MANIFEST.json            step, leaf index (shape, dtype, zvc), extra
        arrays/<name>.npy        one file per leaf, or
        arrays/<name>.npy.zvc.npz  its non-zeros and packed bitmap (ZVC)

Leaves are named by their tree path as the reference's ``_leaf_paths``
names them: dict keys in sorted order joined by ``/``, a named tuple's
fields (``OptState``) as ``.step`` / ``.mu`` / ``.nu``; ``<name>`` is the
path with ``/`` replaced by ``__``.  A bf16 leaf is stored as the
reference's numpy stores an ml_dtypes bfloat16 array — its raw 2-byte
values under the header type ``<V2`` and the manifest dtype
``bfloat16`` — so the files are the same bytes.

Guarantees: **atomic** (written to ``step_XXXXXXXXX.tmp`` and renamed; a
crashed writer never corrupts the latest checkpoint and ``latest_step``
sees only complete ones), **keep-k** (older steps removed after a
successful write) and, with ``zvc=True``, leaves with ≥ 25 % zeros stored
zero-value-compressed (the paper's Fig 12 format at rest).  A ZVC bitmap
counts -0.0 as zero, as the reference's does, so a -0.0 restores as 0.0
there as here.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparsity import zvc_decode_np, zvc_encode_np

_STEP_RE = re.compile(r"^step_(\d{9})$")
ZVC_MIN_SPARSITY = 0.25        # compress only when ≥25 % zeros


def _children(tree):
    """(path component, child) of a container, in the reference's pytree
    order; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _leaf_paths(tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for name, child in kids:
        out.update(_leaf_paths(child, f"{prefix}/{name}" if prefix
                               else name))
    return out


def _fname(path: str) -> str:
    return path.replace("/", "__") + ".npy"


def _host(leaf) -> Tuple[np.ndarray, str, np.ndarray]:
    """(what goes to disk, the manifest dtype, the leaf's values): a bf16
    tensor's raw bits as int16, "bfloat16", its values widened to
    float32; anything else as numpy, its dtype's name, itself."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy(), "bfloat16",
                    t.float().numpy())
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype), arr


def _save_bf16(path: str, bits: np.ndarray) -> None:
    """An .npy of 2-byte raw values whose header reads ``<V2``, byte for
    byte what numpy writes for an ml_dtypes bfloat16 array."""
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(bits.shape)})
        f.write(np.ascontiguousarray(bits).tobytes())


def save(ckpt_dir: str, step: int, state: Dict[str, Any], *,
         extra: Optional[Dict] = None, keep: int = 3,
         zvc: bool = False) -> str:
    """Write ``state`` (nested dicts / named tuples of tensors) atomically
    as step ``step``; keep the ``keep`` newest steps.  ``zvc=True`` stores
    leaves with ≥ 25 % zeros zero-value-compressed."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    arrays_dir = os.path.join(tmp, "arrays")
    os.makedirs(arrays_dir)

    index = {}
    for path, leaf in _leaf_paths(state).items():
        arr, dtype, vals = _host(leaf)
        meta = {"shape": list(arr.shape), "dtype": dtype}
        sparsity = 1.0 - (np.count_nonzero(vals) / max(vals.size, 1))
        if zvc and arr.size and sparsity >= ZVC_MIN_SPARSITY:
            _, bitmap = zvc_encode_np(vals)
            values = arr.reshape(-1)[bitmap.reshape(-1)]
            if dtype == "bfloat16":
                values = values.view("V2")
            np.savez(os.path.join(arrays_dir, _fname(path) + ".zvc"),
                     values=values, bitmap=np.packbits(bitmap.reshape(-1)))
            meta["zvc"] = True
        elif dtype == "bfloat16":
            _save_bf16(os.path.join(arrays_dir, _fname(path)), arr)
        else:
            np.save(os.path.join(arrays_dir, _fname(path)), arr)
        index[path] = meta

    manifest = {"step": step, "index": index, "extra": extra or {}}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "MANIFEST.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a tensor of its manifest dtype (bf16 from its raw
    2-byte values)."""
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr.astype(dtype), copy=True))


def _rebuild(like, restored: Dict[str, torch.Tensor], prefix: str = ""):
    kids = _children(like)
    if kids is None:
        return restored[prefix]
    parts = [_rebuild(child, restored, f"{prefix}/{name}" if prefix
                      else name) for name, child in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), parts))
    if hasattr(like, "_fields"):
        return type(like)(*parts)
    return type(like)(parts)


def restore(ckpt_dir: str, like: Dict[str, Any], *,
            step: Optional[int] = None) -> Tuple[Dict[str, Any], Dict]:
    """Restore into the structure of ``like`` (its leaves give each
    tensor's dtype and device) from step ``step`` (default: the latest).
    Returns (state, manifest["extra"])."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)

    restored = {}
    for path, leaf in _leaf_paths(like).items():
        meta = manifest["index"].get(path, {})
        if meta.get("zvc"):
            with np.load(os.path.join(d, "arrays",
                                      _fname(path) + ".zvc.npz")) as z:
                shape = tuple(meta["shape"])
                n = int(np.prod(shape)) if shape else 1
                bitmap = np.unpackbits(z["bitmap"])[:n].astype(bool)
                arr = zvc_decode_np(z["values"],
                                    bitmap.reshape(shape or (1,)))
                arr = arr.reshape(shape)
        else:
            arr = np.load(os.path.join(d, "arrays", _fname(path)))
        t = _tensor(arr, meta.get("dtype", str(arr.dtype)))
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        restored[path] = t
    return _rebuild(like, restored), manifest["extra"]
