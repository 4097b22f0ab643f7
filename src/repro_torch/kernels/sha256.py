"""Binding of the hand-written CUDA SHA-256 kernel (``csrc/sha256.cu``).

It replaces the Pallas kernel of ``repro/kernels/sha256.py``. The kernel
reads the port's int64 words and writes int64 digest words itself, pads
each row itself, and can write two digests in one launch: of the words as
given (``raw``) and of the words byte-swapped (``bswap``). A call allocates
its outputs and launches that one kernel, nothing else. ``kernels/ops.py``
sends CUDA tensors here and CPU tensors to the plain version in
``kernels/ref.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import native

# Kernel launches since the last reset (a run shows its path went through
# the kernel by reading this; only the launch below adds to it).
launches = 0


def sha256_rows_cuda(msg: torch.Tensor, *, raw: bool = True,
                     bswap: bool = False
                     ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """msg: (N, W) int64 words on a CUDA card -> (raw, bswap) digests,
    each (N, 8) int64 words, or None where not asked for."""
    global launches
    # the host's time counts here (a chunk's kernel runs ~15 us), so the
    # C entry makes the card current itself, with no device context here
    native.check_cuda_words("sha256_rows_cuda", msg, 2)
    n, w = msg.shape
    if w < 1:
        raise ValueError("sha256_rows_cuda: messages need at least one word")
    if not (raw or bswap):
        raise ValueError("sha256_rows_cuda: ask for raw, bswap or both")
    dev = msg.device
    if raw and bswap:
        out_raw, out_bsw = torch.empty((2, n, 8), dtype=torch.int64,
                                       device=dev).unbind(0)
    else:
        out = torch.empty((n, 8), dtype=torch.int64, device=dev)
        out_raw, out_bsw = (out, None) if raw else (None, out)
    if not n:
        return out_raw, out_bsw
    rc = native.library().pnp_sha256_rows(
        msg.data_ptr(), n, w, out_raw.data_ptr() if raw else None,
        out_bsw.data_ptr() if bswap else None, dev.index,
        native.stream_of(msg))
    native.check_launch("sha256_rows_cuda", rc)
    launches += 1
    return out_raw, out_bsw
