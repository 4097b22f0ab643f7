"""Carry chain state from the JAX package into the port.

The functions take the reference's state as plain data (JSON text, numpy
arrays, dicts), never its objects, so this module imports nothing of
``repro``. A block mined by either package can then be verified by the
other, and a model initialised by either runs the same weights in both.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.executor import FullResult
from repro_torch.core.ledger import Block, Ledger
from repro_torch.core.rewards import CreditBook
from repro_torch.device import DeviceLike, resolve


def ledger_from_json(text: str) -> Ledger:
    """A ledger from ``repro.core.ledger.Ledger.to_json()`` output."""
    ledger = Ledger()
    ledger.blocks = [Block(**fields) for fields in json.loads(text)]
    return ledger


def full_result_from_arrays(args, results, hashes, miner_of, leaf_digests,
                            *, device: DeviceLike = None) -> FullResult:
    """A ``FullResult`` from the reference's arrays, in its dtypes."""
    args = np.asarray(args, np.uint32)
    return FullResult(
        args=args,
        results=np.asarray(results, np.uint32).reshape(len(args), -1),
        hashes=np.asarray(hashes, np.uint32),
        miner_of=np.asarray(miner_of, np.int32),
        leaf_digests=np.asarray(leaf_digests, np.uint32),
        device=device)


def credit_book_from_balances(balances: Dict[int, float],
                              total_issued: Optional[float] = None
                              ) -> CreditBook:
    """A ``CreditBook`` from miner balances; ``total_issued`` defaults to
    their sum."""
    book = CreditBook(balances={int(k): float(v)
                                for k, v in balances.items()})
    book.total_issued = (float(total_issued) if total_issued is not None
                         else sum(book.balances.values()))
    return book


def _tensor_from_array(arr, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)         # a writable copy (JAX's buffers are not)
    if arr.dtype.name == "bfloat16":
        # numpy holds JAX's bfloat16 as ml_dtypes.bfloat16, which
        # torch.from_numpy rejects: carry the 16 bits over as they are
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree: Dict[str, Any], *,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's params (a nested dict of numpy or JAX arrays, e.g.
    ``repro``'s ``Model.init`` output) as the port's: the same keys,
    shapes, dtypes and bits, on ``device``."""
    dev = resolve(device)
    return {k: params_from_jax(v, device=dev) if isinstance(v, dict)
            else _tensor_from_array(v, dev) for k, v in tree.items()}


def train_state_from_jax(params: Dict[str, Any], step: Any, m: Dict[str, Any],
                         v: Dict[str, Any], *,
                         device: DeviceLike = None) -> "TrainState":
    """The reference's ``TrainState`` (its params, and its AdamW state's
    step, m and v, as numpy or JAX arrays) as the port's, bits and dtypes
    kept, on ``device``: a checkpoint of either saves to the same bytes."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.steps import TrainState
    dev = resolve(device)
    return TrainState(
        params=params_from_jax(params, device=dev),
        opt=AdamWState(step=_tensor_from_array(np.asarray(step), dev),
                       m=params_from_jax(m, device=dev),
                       v=params_from_jax(v, device=dev)))
