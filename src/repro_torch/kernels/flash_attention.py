"""Bindings of the hand-written CUDA flash-attention kernels, and the rule
that chooses between them.

Both replace the Pallas kernel of ``repro/kernels/flash_attention.py``:
the attention forward with an online softmax, float32 inside, causal by
absolute position, optionally within a local window. Both map each query
head to its KV head by index (GQA and MQA) and mask ragged S and T
themselves. ``csrc/flash_attention_tc.cu`` runs bfloat16 at head dims 64,
128 and 256 on the tensor cores (``flash_attention_tc``);
``csrc/flash_attention.cu`` runs everything else (float32, and head dim
32) on the CUDA cores. ``kernel_for`` is the rule, by dtype and head dim
alone; there is no fallback from one kernel to the other.
``kernels/ops.py`` sends CUDA tensors here and CPU tensors to
``ref.flash_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention_tc, native

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA-core kernel since the last reset (a run shows its
# path went through the kernel by reading this; only the launch below adds
# to it). The tensor-core kernel counts in ``flash_attention_tc.launches``.
launches = 0


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel ``flash_attention_cuda`` launches: "tensor_core" for
    bfloat16 at head dims 64, 128 and 256, "cuda_core" for the rest."""
    if dtype == torch.bfloat16 and head_dim in flash_attention_tc.HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


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
