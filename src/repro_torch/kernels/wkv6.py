"""Binding of the hand-written CUDA WKV-6 kernel (``csrc/wkv6.cu``).

It replaces the Pallas kernel of ``repro/kernels/wkv6.py``: the RWKV-6
recurrence o_t = r_tᵀ(S + (u⊙k_t)v_tᵀ), S ← diag(w_t)S + k_t v_tᵀ over a
whole sequence in one launch, the K x V state in float32. It reads r, k,
v, w in the model's (B, S, H, K) layout, with no fold or transpose copy.
``kernels/ops.py`` sends CUDA tensors here and CPU tensors to
``ref.wkv6_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import native

MAX_DIM = 64                       # K and V a block holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (a run shows its path went through
# the kernel by reading this; only the launch below adds to it).
launches = 0


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtypes, shape) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"wkv6_cuda: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"wkv6_cuda: {name} is {t.dtype}, expected one of "
                        f"{[str(d) for d in dtypes]}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"wkv6_cuda: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"wkv6_cuda: {name} must be contiguous")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k: (B, S, H, K) and v: (B, S, H, V), all float32 or all bfloat16;
    w: (B, S, H, K) float32; u: (H, K) float32; s0: (B, H, K, V) float32 or
    None (zeros); all contiguous on one CUDA card, K and V at most 64.
    Returns (out (B, S, H, V), s_final (B, H, K, V)), both float32."""
    global launches
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"wkv6_cuda: r {tuple(r.shape)} and v "
                         f"{tuple(v.shape)} must have 4 dims")
    B, S, H, K = r.shape
    V = v.shape[-1]
    dev = r.device
    _check("r", r, dev, _DTYPES, (B, S, H, K))
    _check("k", k, dev, (r.dtype,), (B, S, H, K))
    _check("v", v, dev, (r.dtype,), (B, S, H, V))
    _check("w", w, dev, (torch.float32,), (B, S, H, K))
    _check("u", u, dev, (torch.float32,), (H, K))
    if s0 is not None:
        _check("s0", s0, dev, (torch.float32,), (B, H, K, V))
    if not (1 <= K <= MAX_DIM and 1 <= V <= MAX_DIM):
        raise ValueError(f"wkv6_cuda: K={K}, V={V}; each must lie in "
                         f"[1, {MAX_DIM}]")
    out = torch.empty((B, S, H, V), dtype=torch.float32, device=dev)
    s_final = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    if B and H:
        with torch.cuda.device(dev):
            rc = native.library().pnp_wkv6(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if s0 is None else s0.data_ptr(),
                out.data_ptr(), s_final.data_ptr(), B, S, H, K, V,
                _DTYPES[r.dtype], native.stream_of(r))
        launches += 1
        native.check_launch("wkv6_cuda", rc)
    return out, s_final
