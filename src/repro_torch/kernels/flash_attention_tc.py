"""Binding of the hand-written tensor-core flash-attention kernel
(``csrc/flash_attention_tc.cu``) for bfloat16 at head dims 64, 80, 128 and
256 (80 runs the hd-128 pipeline on zero-filled columns).

It computes what ``flash_attention.flash_attention_cuda_core`` computes, the
function of the reference's Pallas flash kernel, with both products on
Hopper's tensor cores (``wgmma``), K and V brought by TMA and a
warp-specialised pipeline. ``flash_attention.flash_attention_cuda`` sends
it the calls that ``flash_attention.kernel_for`` assigns to it. Its training
instance (``flash_attention_tc_lse_cuda``, hd 64, 128 and 256) also saves
each row's log-sum-exp for the bf16 backward (``flash_attention_tc_bwd`` at
hd 64 and 128, ``flash_attention_mma_bwd`` at 256).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

HEAD_DIMS = (64, 80, 128, 256)
# the training instance (with the row log-sum-exp), as the backwards'
TRAIN_HEAD_DIMS = (64, 128, 256)

# Kernel launches since the last reset (a run shows its path went through
# the kernel by reading this; only the launches below add to it), and of
# those the training instance's (``flash_attention_tc_lse_cuda``) alone.
launches = 0
lse_launches = 0


def _check_tma_strides(name: str, *tensors: torch.Tensor) -> None:
    """TMA also needs each row stride in bytes to be a multiple of 16."""
    for arg, t in zip(("q", "k", "v"), tensors):
        for stride in t.stride()[:-1]:
            if stride * t.element_size() % 16:
                raise ValueError(f"{name}: {arg} has a row stride of "
                                 f"{stride * t.element_size()} bytes, not a "
                                 "multiple of 16 (TMA)")


def flash_attention_tc_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool,
                            window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, Kv, hd), bfloat16, contiguous, on one
    CUDA card, hd in ``HEAD_DIMS`` -> (B, S, H, hd) bfloat16. ``window >
    0``: query s sees only keys t > s - window."""
    global launches
    native.check_qkv("flash_attention_tc_cuda", q, k, v, window,
                     (torch.bfloat16,), HEAD_DIMS)
    _check_tma_strides("flash_attention_tc_cuda", q, k, v)
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B and S:
        with torch.cuda.device(q.device):
            rc = native.library().pnp_flash_attention_tc_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, T, H, Kv, hd, int(causal), int(window),
                native.stream_of(q))
        launches += 1
        native.check_launch("flash_attention_tc_cuda", rc)
    return out


def flash_attention_tc_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool,
                                window: int = 0):
    """The training instance: bfloat16 q (B, S, H, hd), k, v (B, T, Kv, hd)
    with hd in ``TRAIN_HEAD_DIMS`` -> (out (B, S, H, hd) bfloat16, lse (B,
    H, S) float32), lse each row's log-sum-exp of its scaled, masked scores
    in natural-log units (-1e30 for a row that sees no key). The output is
    the serving instance's, bit for bit."""
    global launches, lse_launches
    native.check_qkv("flash_attention_tc_lse_cuda", q, k, v, window,
                     (torch.bfloat16,), TRAIN_HEAD_DIMS)
    _check_tma_strides("flash_attention_tc_lse_cuda", q, k, v)
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B and S:
        with torch.cuda.device(q.device):
            rc = native.library().pnp_flash_attention_tc_fwd_lse(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, S, T, H, Kv, hd, int(causal), int(window),
                native.stream_of(q))
        launches += 1
        lse_launches += 1
        native.check_launch("flash_attention_tc_lse_cuda", rc)
    return out, lse
