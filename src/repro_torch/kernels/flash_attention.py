"""Binding of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

It replaces the Pallas kernel of ``repro/kernels/flash_attention.py``:
the attention forward with an online softmax, float32 inside, causal by
absolute position, optionally within a local window. It maps each query
head to its KV head by index (GQA and MQA) and masks ragged S and T
itself. ``kernels/ops.py`` sends CUDA tensors here
and CPU tensors to ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (a run shows its path went through
# the kernel by reading this; only the launch below adds to it).
launches = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, Kv, hd) on one CUDA card, contiguous,
    float32 or bfloat16 -> (B, S, H, hd) in q's dtype. ``window > 0``: query
    s sees only keys t > s - window."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is on "
                             f"{t.device}, expected a CUDA tensor")
        if t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k, v on different "
                             "devices")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention_cuda: {name} is {t.dtype}; "
                            "q, k, v must all be float32 or all bfloat16")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected 4 dims")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must start on "
                             "a 16-byte boundary")
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, Kv, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if Kv < 1 or H % Kv:
        raise ValueError(f"flash_attention_cuda: {H} heads over {Kv} KV "
                         "heads")
    if T < 1:
        raise ValueError("flash_attention_cuda: no keys")
    if window < 0:
        raise ValueError(f"flash_attention_cuda: window {window} < 0")
    out = torch.empty_like(q)
    if B and S:
        with torch.cuda.device(q.device):
            rc = native.library().pnp_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, T, H, Kv, hd, int(causal), int(window), _DTYPES[q.dtype],
                native.stream_of(q))
        launches += 1
        native.check_launch("flash_attention_cuda", rc)
    return out
