"""Checkpointing with ledger integration: the port of
``repro/train/checkpoint.py``.

A checkpoint is the reference's ``.npz`` bundle of the state byte for
byte: ``np.savez``'s container (stored zip entries, zip64 headers, entries
dated 1980-01-01) holding one ``.npy`` a leaf, under the reference's keys
(JAX's path names: a named tuple's field as ``.name``, a dict key as
itself, ``/`` between, so ``.params/embed``, ``.opt/.step``,
``.opt/.m/embed``), leaves in JAX's flattening order. A bfloat16 leaf is
written as numpy writes a JAX bfloat16 array: its 16 bits under the
descriptor ``'<V2'``. So a state carried across by ``convert`` saves to a
file with the same SHA-256 in both packages, and every save returns that
digest, which the chain can anchor (the paper's transparency goal, §5).

``load_checkpoint`` restores a ``'<V2'`` leaf into a bfloat16 leaf by its
bits. The reference casts it (``jnp.asarray(arr, dtype)``), which numpy
cannot do from a void type, so it cannot reload its own bf16 checkpoints:
the port departs from it there (ROADMAP.md §3).
"""
from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.train.steps import BF16_DTYPE_STR, host_leaf

_CHUNK = 1 << 24


def _join(path: str, part: str) -> str:
    return f"{path}/{part}" if path else part


def _flatten(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of a tree of named tuples and dicts, in JAX's flattening
    order and path names: named-tuple fields in order as ``.name``, dict
    keys sorted."""
    if isinstance(tree, tuple):
        for name, value in zip(tree._fields, tree):
            yield from _flatten(value, _join(path, f".{name}"))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], _join(path, str(k)))
    else:
        yield path, tree


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as a C-contiguous host array and its dtype string
    (``steps.host_leaf``: a bfloat16 leaf as its bits under ``'<V2'``)."""
    arr, dtype = host_leaf(leaf)
    # order="C", not ascontiguousarray: a 0-d leaf (the step) stays 0-d
    return np.asarray(arr, order="C"), dtype


def _write_npy(fid, arr: np.ndarray, dtype: str) -> None:
    """One ``.npy`` entry as ``np.save`` writes it; a bfloat16 leaf gets
    the reference's ``'<V2'`` header over its bits."""
    if dtype != BF16_DTYPE_STR:
        np.lib.format.write_array(fid, arr, allow_pickle=False)
        return
    np.lib.format.write_array_header_1_0(
        fid, {"descr": dtype, "fortran_order": False, "shape": arr.shape})
    fid.write(memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B"))


def file_digest(path: str) -> str:
    """SHA-256 hex digest of a file's bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def save_checkpoint(path: str, state: Any, meta: Dict | None = None) -> str:
    """Serialize ``state`` to ``path``; returns the SHA-256 hex digest.
    With ``meta``, also writes ``path + ".meta.json"``: the meta and the
    digest. Leaves go to the host one at a time, straight into the file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # np.savez's container: stored entries, zip64 forced on each
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in _flatten(state):
            arr, dtype = _host(leaf)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                _write_npy(fid, arr, dtype)
            del arr
    digest = file_digest(path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump({**meta, "sha256": digest}, f, indent=2)
    return digest


def _restore(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise TypeError(f"a bfloat16 leaf from a {arr.dtype} entry")
        bits = torch.from_numpy(np.array(arr, order="C").view(np.int16))
        return bits.view(torch.bfloat16).to(like.device)
    return torch.from_numpy(np.array(arr)).to(device=like.device,
                                              dtype=like.dtype)


def _unflatten(like: Any, arrays, path: str = "") -> Any:
    if isinstance(like, tuple):
        return type(like)(*(_unflatten(v, arrays, _join(path, f".{n}"))
                            for n, v in zip(like._fields, like)))
    if isinstance(like, dict):
        return {k: _unflatten(v, arrays, _join(path, str(k)))
                for k, v in like.items()}
    return _restore(arrays[path], like)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, str]:
    """Restore into the structure, dtypes and devices of ``like``; returns
    (state, digest of the file)."""
    digest = file_digest(path)
    # the npz reads an entry when asked for it: one leaf on the host at a
    # time
    with np.load(path) as npz:
        state = _unflatten(like, npz)
    return state, digest


def state_digest(state: Any) -> str:
    """Order-stable digest of a live state (no file round trip): each key,
    sorted, then its leaf's bytes (a bfloat16 leaf's bits), as the
    reference hashes them."""
    flat = {key: leaf for key, leaf in _flatten(state)}
    h = hashlib.sha256()
    for key in sorted(flat):
        h.update(key.encode())
        h.update(_host(flat[key])[0].tobytes())
    return h.hexdigest()
