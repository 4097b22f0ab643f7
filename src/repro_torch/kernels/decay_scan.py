"""Binding of the hand-written CUDA decay-scan kernels
(``csrc/decay_scan.cu``).

They replace the Pallas kernel of ``repro/kernels/decay_scan.py``: the
RG-LRU inner recurrence h_t = a_t·h_{t-1} + b_t over a whole sequence in
one launch, in float32. ``decay_scan_cuda`` is the path's: tiles of 64
channels by 128 steps taken in order from a ticket, loads staged ahead of the
carry, the carry handed from chunk to chunk. ``decay_scan_cuda_per_chain``
(one thread a chain over all steps) computes the same bits and is kept to
hold the tiled kernel against; no path calls it. No channel padding is
needed. ``kernels/ops.py`` sends CUDA tensors here and CPU tensors to
``ref.decay_scan_ref``.

For training, ``DecayScan`` is the autograd Function: its forward is
``decay_scan_cuda``, its backward ``decay_scan_bwd_cuda``, the hand-written
reverse scan of ``csrc/decay_scan_bwd.cu`` on the saved a and h (plain
version: ``ref.decay_scan_bwd_ref``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import native

# Launches of the tiled kernel from ``decay_scan_cuda`` since the last
# reset (a run shows its path went through the kernel by reading this; only
# the launch there adds to it), and of the backward kernel from
# ``decay_scan_bwd_cuda``.
launches = 0
bwd_launches = 0

# Zeroed workspace of the tiled kernel (its ticket and carries), one per
# card and stream: launches that share one must be ordered, and each leaves
# it zero for the next.
_workspace: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace_for(a: torch.Tensor, B: int, C: int) -> torch.Tensor:
    words = native.library().pnp_decay_scan_workspace_words(B, C)
    key = (a.device.index, native.stream_of(a))
    ws = _workspace.get(key)
    if ws is None or ws.numel() < words:
        ws = torch.zeros(words, dtype=torch.int64, device=a.device)
        _workspace[key] = ws
    return ws


def _checked(name: str, a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    if a.dim() != 3:
        raise ValueError(f"{name}: a has shape {tuple(a.shape)}, "
                         "expected (B, S, C)")
    B, S, C = a.shape
    named = [("a", a, (B, S, C)), ("b", b, (B, S, C))]
    if h0 is not None:
        named.append(("h0", h0, (B, C)))
    for arg, t, shape in named:
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"expected a CUDA tensor on {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}, "
                            "expected torch.float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return B, S, C


def _run(name: str, a: torch.Tensor, b: torch.Tensor,
         h0: Optional[torch.Tensor], tiled: bool
         ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Check, allocate and launch the tiled kernel, or the per-chain one.
    Returns (h, h_last, launched)."""
    B, S, C = _checked(name, a, b, h0)
    out = torch.empty_like(a)
    h_last = torch.empty((B, C), dtype=torch.float32, device=a.device)
    if not (B and C):
        return out, h_last, False
    h0_ptr = None if h0 is None else h0.data_ptr()
    with torch.cuda.device(a.device):
        lib, stream = native.library(), native.stream_of(a)
        if tiled:
            ws = _workspace_for(a, B, C)
            rc = lib.pnp_decay_scan(
                a.data_ptr(), b.data_ptr(), h0_ptr, out.data_ptr(),
                h_last.data_ptr(), B, S, C, ws.data_ptr(), stream)
        else:
            rc = lib.pnp_decay_scan_per_chain(
                a.data_ptr(), b.data_ptr(), h0_ptr, out.data_ptr(),
                h_last.data_ptr(), B, S, C, stream)
    native.check_launch(name, rc)
    return out, h_last, True


def decay_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, S, C) and h0: (B, C) or None (zeros), float32, contiguous,
    on one CUDA card -> (h (B, S, C), h_last (B, C)), float32; h_last is h0
    where S = 0. One launch of the tiled kernel."""
    global launches
    out, h_last, launched = _run("decay_scan_cuda", a, b, h0, True)
    launches += launched
    return out, h_last


def decay_scan_cuda_per_chain(a: torch.Tensor, b: torch.Tensor,
                              h0: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function by the one-thread-a-chain kernel, which the tiled
    kernel must equal bit for bit; no path calls it, and it is not
    counted."""
    out, h_last, _ = _run("decay_scan_cuda_per_chain", a, b, h0, False)
    return out, h_last


def decay_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                        dh_last: Optional[torch.Tensor] = None,
                        h0: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients (da, db) of ``decay_scan_cuda``'s (h, h_last) from a
    and its output h, dh (B, S, C) and dh_last (B, C) or None (zeros); h0
    (B, C) or None is the start the forward ran from. float32, contiguous,
    on one CUDA card. One launch of ``csrc/decay_scan_bwd.cu``."""
    global bwd_launches
    B, S, C = _checked("decay_scan_bwd_cuda", a, h, h0)
    _checked("decay_scan_bwd_cuda", a, dh, dh_last)
    da, db = torch.empty_like(a), torch.empty_like(a)
    if B and C:
        ptr = (lambda t: None if t is None else t.data_ptr())
        with torch.cuda.device(a.device):
            rc = native.library().pnp_decay_scan_bwd(
                a.data_ptr(), h.data_ptr(), ptr(h0), dh.data_ptr(),
                ptr(dh_last), da.data_ptr(), db.data_ptr(), None, B, S, C,
                native.stream_of(a))
        bwd_launches += 1
        native.check_launch("decay_scan_bwd_cuda", rc)
    return da, db


class DecayScan(torch.autograd.Function):
    """The decay scan with its gradient on the card: forward
    ``decay_scan_cuda``, backward ``decay_scan_bwd_cuda`` on the saved a,
    h and h0. h0 takes no gradient (``kernels/ops.py`` raises if it asks
    for one)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = decay_scan_cuda(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.set_materialize_grads(False)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        da, db = decay_scan_bwd_cuda(
            a, h, dh.contiguous(),
            None if dh_last is None else dh_last.contiguous(), h0)
        return da, db, None
