"""Binding of the hand-written CUDA SHA-256 kernel (``csrc/sha256.cu``).

It replaces the Pallas kernel of ``repro/kernels/sha256.py``. The kernel
pads each row itself and can write two digests in one launch: of the words
as given (``raw``) and of the words byte-swapped (``bswap``).
``kernels/ops.py`` sends CUDA tensors here and CPU tensors to the plain
version in ``kernels/ref.py``.
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
    native.check_cuda_words("sha256_rows_cuda", msg, 2)
    n, w = msg.shape
    if w < 1:
        raise ValueError("sha256_rows_cuda: messages need at least one word")
    if not (raw or bswap):
        raise ValueError("sha256_rows_cuda: ask for raw, bswap or both")
    m32 = native.to_i32(msg)
    out_raw = torch.empty((n, 8), dtype=torch.int32, device=msg.device) \
        if raw else None
    out_bsw = torch.empty((n, 8), dtype=torch.int32, device=msg.device) \
        if bswap else None
    if n:
        with torch.cuda.device(msg.device):
            rc = native.library().pnp_sha256_rows(
                m32.data_ptr(), n, w,
                out_raw.data_ptr() if raw else None,
                out_bsw.data_ptr() if bswap else None,
                native.stream_of(msg))
        launches += 1
        native.check_launch("sha256_rows_cuda", rc)
    return (native.from_i32(out_raw) if raw else None,
            native.from_i32(out_bsw) if bswap else None)
