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

A state placed over a mesh (``parallel.sharding.Sharded`` leaves) is saved
whole, one entry a leaf, as the reference saves its global arrays (mamba's
``in_proj``, placed as two halves, as its (..., 2 * d_inner) whole); a
placed template loads each leaf back under its spec on its mesh.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.parallel import sharding


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


def _halved(key: str) -> bool:
    return key.split("/")[-1] in sharding.HALVED


def _whole(key: str, leaf: sharding.Sharded) -> torch.Tensor:
    """A placed leaf as the reference's whole array, on the CPU."""
    t = sharding.unshard(leaf, "cpu")
    return t.flatten(-2) if _halved(key) else t


def _to_numpy(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, sharding.Sharded):
        leaf = _whole(key, leaf)
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
    tensors included, or of placed ``Sharded`` leaves): each leaf takes the
    reference leaf's dtype and device (the CPU for a meta tensor), a placed
    leaf its spec on its mesh (``sharding.shard``).  A missing key raises
    ``KeyError``, a shape that differs ``ValueError``, a bfloat16 array
    ``TypeError``."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__metadata__"].tobytes()).decode())
        leaves = {}
        for key, ref in _flatten(like):
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = data[key]
            placed = isinstance(ref, sharding.Sharded)
            shape = tuple(ref.shape)
            if placed and _halved(key):
                shape = shape[:-2] + (2 * shape[-1],)
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"{key}: shape {arr.shape} != expected {shape}")
            if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
                raise TypeError(f"{key}: a bfloat16 array ({arr.dtype}) "
                                f"needs ml_dtypes; save the state in fp32")
            t = torch.from_numpy(np.array(arr))
            if placed:
                t = t.to(ref.blocks[0].dtype).reshape(ref.shape)
                leaves[key] = sharding.shard(t, ref.spec, ref.mesh)
                continue
            device = "cpu" if ref.device.type == "meta" else ref.device
            leaves[key] = t.to(device=device, dtype=ref.dtype)
    return _unflatten(like, leaves), meta
