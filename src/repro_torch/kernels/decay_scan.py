"""Binding of the hand-written CUDA decay-scan kernel
(``csrc/decay_scan.cu``).

It replaces the Pallas kernel of ``repro/kernels/decay_scan.py``: the
RG-LRU inner recurrence h_t = a_t·h_{t-1} + b_t over a whole sequence in
one launch, one thread per (batch row, channel), in float32. No channel
padding is needed. ``kernels/ops.py`` sends CUDA tensors here and CPU
tensors to ``ref.decay_scan_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import native

# Kernel launches since the last reset (a run shows its path went through
# the kernel by reading this; only the launch below adds to it).
launches = 0


def decay_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, S, C) and h0: (B, C) or None (zeros), float32, contiguous,
    on one CUDA card -> (h (B, S, C), h_last (B, C)), float32; h_last is h0
    where S = 0."""
    global launches
    if a.dim() != 3:
        raise ValueError(f"decay_scan_cuda: a has shape {tuple(a.shape)}, "
                         "expected (B, S, C)")
    B, S, C = a.shape
    named = [("a", a, (B, S, C)), ("b", b, (B, S, C))]
    if h0 is not None:
        named.append(("h0", h0, (B, C)))
    for name, t, shape in named:
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"decay_scan_cuda: {name} is on {t.device}, "
                             f"expected a CUDA tensor on {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"decay_scan_cuda: {name} is {t.dtype}, "
                            "expected torch.float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"decay_scan_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"decay_scan_cuda: {name} must be contiguous")
    out = torch.empty_like(a)
    h_last = torch.empty((B, C), dtype=torch.float32, device=a.device)
    if B and C:
        with torch.cuda.device(a.device):
            rc = native.library().pnp_decay_scan(
                a.data_ptr(), b.data_ptr(),
                None if h0 is None else h0.data_ptr(), out.data_ptr(),
                h_last.data_ptr(), B, S, C, native.stream_of(a))
        launches += 1
        native.check_launch("decay_scan_cuda", rc)
    return out, h_last
