"""Binding of the hand-written tensor-core flash-attention kernel
(``csrc/flash_attention_tc.cu``) for bfloat16 at head dims 64, 128 and 256.

It computes what ``flash_attention.flash_attention_cuda_core`` computes, the
function of the reference's Pallas flash kernel, with both products on
Hopper's tensor cores (``wgmma``), K and V brought by TMA and a
warp-specialised pipeline. ``flash_attention.flash_attention_cuda`` sends
it the calls that ``flash_attention.kernel_for`` assigns to it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

HEAD_DIMS = (64, 128, 256)

# Kernel launches since the last reset (a run shows its path went through
# the kernel by reading this; only the launch below adds to it).
launches = 0


def flash_attention_tc_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool,
                            window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, Kv, hd), bfloat16, contiguous, on one
    CUDA card, hd in ``HEAD_DIMS`` -> (B, S, H, hd) bfloat16. ``window >
    0``: query s sees only keys t > s - window."""
    global launches
    native.check_qkv("flash_attention_tc_cuda", q, k, v, window,
                     (torch.bfloat16,), HEAD_DIMS)
    # TMA also needs each row stride in bytes to be a multiple of 16
    for name, t in (("q", q), ("k", k), ("v", v)):
        for stride in t.stride()[:-1]:
            if stride * t.element_size() % 16:
                raise ValueError(f"flash_attention_tc_cuda: {name} has a row "
                                 f"stride of {stride * t.element_size()} "
                                 "bytes, not a multiple of 16 (TMA)")
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
