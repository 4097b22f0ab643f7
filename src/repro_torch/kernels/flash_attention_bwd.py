"""Binding of the hand-written attention backward
(``csrc/flash_attention_bwd.cu``): dQ, dK and dV of the attention the
CUDA-core flash kernel computes, in float32 on the CUDA cores.

The reference has no Pallas backward (``jax.grad`` differentiates
``repro.models.attention.chunked_attention``); the port's training step
reaches this through ``flash_attention.FlashAttention``. Two kernel
launches a call, with every sum in a fixed order (no atomics), so two
calls give the same bits. Plain version: ``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import native

HEAD_DIMS = (32, 64, 128)

# Calls of the backward since the last reset (each launches its two
# kernels); only the call below adds to it.
launches = 0


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """q, out, dout (B, S, H, hd); k, v (B, T, Kv, hd); lse (B, H, S), the
    forward's row log-sum-exp; float32 on one CUDA card, contiguous, hd in
    ``HEAD_DIMS`` -> (dq, dk, dv) like q, k, v. Raises for any other
    input: there is no fallback."""
    global launches
    if q.dtype != torch.float32:
        raise TypeError(
            f"flash_attention_bwd_cuda: {q.dtype}; the backward is float32 "
            "only (bf16 training: ROADMAP.md §1, item 4)")
    native.check_qkv("flash_attention_bwd_cuda", q, k, v, window,
                     {torch.float32: 0}, HEAD_DIMS)
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (B, H, S))):
        if (not t.is_cuda or t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(
                f"flash_attention_bwd_cuda: {name} must be a contiguous "
                f"float32 {tuple(shape)} tensor on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    if B and S:
        workspace = torch.empty((B, H, S), dtype=torch.float32,
                                device=q.device)
        with torch.cuda.device(q.device):
            rc = native.library().pnp_flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), workspace.data_ptr(), B, S, T,
                H, Kv, hd, int(causal), int(window), native.stream_of(q))
        launches += 1
        native.check_launch("flash_attention_bwd_cuda", rc)
    return dq, dk, dv
