"""Checkpointing: param / optimizer trees <-> ``.npz`` files, in the
reference's own format (``steps/checkpoint.py``).

A key is the leaf's tree path, dict keys and sequence indices joined by
``/`` (``0/blocks/attn/wq``, ``1/m/embed``, ``1/step`` for a
``(params, opt_state)`` pair); the ``__metadata__`` entry holds a JSON
object as uint8 bytes.  The write is atomic (a temporary file, then a
rename).  ``load`` rebuilds into the structure of a reference tree and
checks every leaf's presence and shape with the reference's messages, so a
checkpoint either package writes loads in the other.

bfloat16 leaves are refused with a ``TypeError`` naming the leaf: numpy
holds bf16 only through ``ml_dtypes``, which the card's machine lacks.  The
training state is fp32 (params and moments) and int32 (the step).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _flatten(tree, path: Tuple = ()) -> List[Tuple[str, Any]]:
    """(path key, leaf) pairs in the reference's order: dict keys sorted,
    sequences in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree) for kv in
                _flatten(t, path + (str(i),))]
    return [("/".join(path), tree)]


def _to_numpy(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"{key}: a bfloat16 leaf has no numpy dtype "
                            f"without ml_dtypes; save the state in fp32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, metadata: Dict[str, Any] | None = None) -> None:
    arrays = {key: _to_numpy(key, leaf) for key, leaf in _flatten(tree)}
    arrays["__metadata__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # atomic write: tmp + rename
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _unflatten(like, leaves, path: Tuple = ()):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(t, leaves, path + (str(i),))
                          for i, t in enumerate(like))
    return leaves["/".join(path)]


def load(path: str, like: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors included): each leaf takes the reference leaf's dtype and
    device (the CPU for a meta tensor).  A missing key raises
    ``KeyError``, a shape that differs ``ValueError``, a bfloat16 array
    ``TypeError``."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__metadata__"].tobytes()).decode())
        leaves = {}
        for key, ref in _flatten(like):
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"{key}: shape {arr.shape} != expected "
                    f"{tuple(ref.shape)}")
            if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
                raise TypeError(f"{key}: a bfloat16 array ({arr.dtype}) "
                                f"needs ml_dtypes; save the state in fp32")
            device = "cpu" if ref.device.type == "meta" else ref.device
            leaves[key] = torch.from_numpy(np.array(arr)).to(
                device=device, dtype=ref.dtype)
    return _unflatten(like, leaves), meta
