"""Bindings of the hand-written CUDA flash-attention kernels, and the rule
that chooses between them.

Both replace the Pallas kernel of ``repro/kernels/flash_attention.py``:
the attention forward with an online softmax, float32 inside, causal by
absolute position, optionally within a local window. Both map each query
head to its KV head by index (GQA and MQA) and mask ragged S and T
themselves. ``csrc/flash_attention_tc.cu`` runs bfloat16 at head dims 64,
80, 128 and 256 on the tensor cores (``flash_attention_tc``);
``csrc/flash_attention.cu`` runs everything else (float32, and head dims
16 and 32) on the CUDA cores. ``kernel_for`` is the rule, by dtype and
head dim alone; there is no fallback from one kernel to the other.
``kernels/ops.py`` sends CUDA tensors here and CPU tensors to
``ref.flash_attention_ref``.

For training, ``FlashAttention`` is the autograd Function: in float32 its
forward launches the CUDA-core kernel's instance that also saves each
row's log-sum-exp (``flash_attention_lse_cuda``) and its backward the
CUDA-core backward (``flash_attention_bwd.flash_attention_bwd_cuda``); in
bfloat16 at head dims 64, 128 and 256 the tensor-core kernel's training
instance (``flash_attention_tc.flash_attention_tc_lse_cuda``) and a
tensor-core backward (``flash_attention_tc_bwd`` at 64 and 128,
``flash_attention_mma_bwd`` at 256). ``train_kernels_for`` is that rule;
any other dtype or head dim raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (flash_attention_bwd,
                                 flash_attention_mma_bwd, flash_attention_tc,
                                 flash_attention_tc_bwd, native)

HEAD_DIMS = (16, 32, 64, 128, 256)
# the training instance (with the row log-sum-exp) and the backward
TRAIN_HEAD_DIMS = flash_attention_bwd.HEAD_DIMS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA-core kernel since the last reset (a run shows its
# path went through the kernel by reading this; only the launches below add
# to it), and of those its training instance's (``flash_attention_lse_cuda``)
# alone. The tensor-core kernel counts in ``flash_attention_tc.launches``.
launches = 0
lse_launches = 0


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel ``flash_attention_cuda`` launches: "tensor_core" for
    bfloat16 at head dims 64, 80, 128 and 256, "cuda_core" for the rest."""
    if dtype == torch.bfloat16 and head_dim in flash_attention_tc.HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def train_kernels_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernels ``FlashAttention`` launches: "cuda_core" for float32 at
    ``TRAIN_HEAD_DIMS``, "tensor_core" for bfloat16 at
    ``flash_attention_tc.TRAIN_HEAD_DIMS``; anything else raises, naming
    the instance it lacks."""
    if dtype == torch.float32 and head_dim in TRAIN_HEAD_DIMS:
        return "cuda_core"
    if (dtype == torch.bfloat16
            and head_dim in flash_attention_tc.TRAIN_HEAD_DIMS):
        return "tensor_core"
    raise TypeError(
        f"flash attention with grad: no training instance for {dtype} at "
        f"head dim {head_dim} (float32 at {TRAIN_HEAD_DIMS}, bfloat16 at "
        f"{flash_attention_tc.TRAIN_HEAD_DIMS}; bfloat16 at head dim 80: "
        "ROADMAP.md §1, item 4, stablelm-3b's training pair)")


def tile(head_dim: int) -> dict:
    """The CUDA-core kernel's tile at ``head_dim`` (constants in its source)
    and what the runtime reports for its float32 instance: query rows a
    block, keys a tile, stages of its K and V rings, threads, dynamic shared
    bytes, registers a thread and local (spilled) bytes."""
    import ctypes
    out = (ctypes.c_int32 * 7)()
    native.check_launch("flash_attention tile",
                        native.library().pnp_flash_attention_info(
                            head_dim, out))
    keys = ("block_rows", "block_keys", "stages", "threads", "shared_bytes",
            "registers", "local_bytes")
    return dict(zip(keys, out))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, Kv, hd) on one CUDA card, contiguous,
    float32 or bfloat16 -> (B, S, H, hd) in q's dtype. ``window > 0``: query
    s sees only keys t > s - window. Launches the kernel ``kernel_for``
    names."""
    if kernel_for(q.dtype, q.shape[-1]) == "tensor_core":
        return flash_attention_tc.flash_attention_tc_cuda(
            q, k, v, causal=causal, window=window)
    return flash_attention_cuda_core(q, k, v, causal=causal, window=window)


def flash_attention_cuda_core(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool,
                              window: int = 0) -> torch.Tensor:
    """The CUDA-core kernel, at any dtype and head dim it takes: q (B, S, H,
    hd); k, v (B, T, Kv, hd) on one CUDA card, contiguous, float32 or
    bfloat16, hd in ``HEAD_DIMS`` -> (B, S, H, hd) in q's dtype."""
    global launches
    native.check_qkv("flash_attention_cuda_core", q, k, v, window, _DTYPES,
                     HEAD_DIMS)
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B and S:
        with torch.cuda.device(q.device):
            rc = native.library().pnp_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, T, H, Kv, hd, int(causal), int(window), _DTYPES[q.dtype],
                native.stream_of(q))
        launches += 1
        native.check_launch("flash_attention_cuda_core", rc)
    return out


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool,
                             window: int = 0):
    """The CUDA-core kernel's training instance: float32 q (B, S, H, hd), k,
    v (B, T, Kv, hd) with hd in ``TRAIN_HEAD_DIMS`` -> (out (B, S, H, hd),
    lse (B, H, S)), lse each row's log-sum-exp of its scaled, masked scores
    in natural-log units. The output is the serving instance's, bit for
    bit."""
    global launches, lse_launches
    native.check_qkv("flash_attention_lse_cuda", q, k, v, window,
                     {torch.float32: 0}, TRAIN_HEAD_DIMS)
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B and S:
        with torch.cuda.device(q.device):
            rc = native.library().pnp_flash_attention_fwd_lse(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, S, T, H, Kv, hd, int(causal), int(window),
                native.stream_of(q))
        launches += 1
        lse_launches += 1
        native.check_launch("flash_attention_lse_cuda", rc)
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient on the card: the forward is a kernel's
    training instance, the backward a hand-written backward kernel on the
    saved q, k, v, output and row log-sum-exp, as ``train_kernels_for``
    chooses: float32 at head dims 16, 32, 64 and 128 on the CUDA cores,
    bfloat16 at 64, 128 and 256 on the tensor cores. Anything else
    raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        kind = train_kernels_for(q.dtype, q.shape[-1])
        fwd = (flash_attention_lse_cuda if kind == "cuda_core"
               else flash_attention_tc.flash_attention_tc_lse_cuda)
        out, lse = fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.kind = causal, window, kind
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.kind == "cuda_core":
            bwd = flash_attention_bwd.flash_attention_bwd_cuda
        elif q.shape[-1] in flash_attention_mma_bwd.HEAD_DIMS:
            bwd = flash_attention_mma_bwd.flash_attention_mma_bwd_cuda
        else:
            bwd = flash_attention_tc_bwd.flash_attention_tc_bwd_cuda
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(),
                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
