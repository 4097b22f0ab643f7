"""Binding of the hand-written bfloat16 attention backward at head dim 256
(``csrc/flash_attention_mma_bwd.cu``): dQ, dK and dV of the attention the
tensor-core flash kernel computes, every product an ``mma.sync`` bf16
tensor-core product with float32 accumulators.

The reference has no Pallas backward (``jax.grad`` differentiates
``repro.models.attention.chunked_attention``); the port's bf16 training
step reaches this through ``flash_attention.FlashAttention`` at head dim
256 (recurrentgemma-2b's local attention). ``flash_attention_tc_bwd`` takes
head dims 64 and 128. Three kernel launches a call: D = rowsum(dO o); dK
and dV of a tile of 64 keys and one half of the head dim's columns, storing
dS^T for every batch row; dQ = dS K from it. Every sum runs in a fixed order
(no atomics), so two calls give the same bits. Plain version:
``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import native

HEAD_DIMS = (256,)
TILE = 64           # query rows and keys a tile (constants in the source)

# Calls of the backward since the last reset (each launches its three
# kernels once); only the call below adds to it.
launches = 0


def tile() -> dict:
    """The backward's tiles and what the runtime reports for each of its
    kernels: registers a thread and local (spilled) bytes."""
    import ctypes
    out = (ctypes.c_int32 * 10)()
    native.check_launch("flash_attention_mma_bwd tile",
                        native.library().pnp_flash_attention_mma_bwd_info(out))
    res = {"block_rows": out[0], "block_keys": out[1],
           "dkv_shared_bytes": out[2], "dq_shared_bytes": out[3]}
    for name, at in (("dot_kernel", 4), ("dkv_kernel", 6), ("dq_kernel", 8)):
        res[name + "_resources"] = {"registers": out[at],
                                    "local_bytes": out[at + 1]}
    return res


def _padded(n: int) -> int:
    return -(-n // TILE) * TILE


def flash_attention_mma_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, dout: torch.Tensor, *,
                                 causal: bool, window: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """q, out, dout (B, S, H, 256) and k, v (B, T, Kv, 256) bfloat16; lse
    (B, H, S) float32, the training forward's row log-sum-exp; contiguous,
    on one CUDA card -> (dq, dk, dv) like q, k, v, in bfloat16. Raises for
    any other input: there is no fallback."""
    global launches
    name = "flash_attention_mma_bwd_cuda"
    native.check_qkv(name, q, k, v, window, (torch.bfloat16,), HEAD_DIMS)
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    for arg, t, shape, dtype in (
            ("out", out, q.shape, torch.bfloat16),
            ("dout", dout, q.shape, torch.bfloat16),
            ("lse", lse, (B, H, S), torch.float32)):
        if (not t.is_cuda or t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"{name}: {arg} must be a contiguous {dtype} {tuple(shape)} "
                f"tensor on {q.device}, 16-byte aligned, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    dq = torch.empty_like(q)
    # with no query, no key gets a gradient, and no kernel runs
    alloc = torch.empty_like if B and S else torch.zeros_like
    dk, dv = alloc(k), alloc(v)
    if B and S:
        # dS^T for all B rows: 21 MB at recurrentgemma-2b's training call
        # (B 16, S = T 256, H 10), 671 MB at B 2, S = T 4096
        d_ws = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        ds_ws = torch.empty((B, H, _padded(T), _padded(S)),
                            dtype=torch.bfloat16, device=q.device)
        with torch.cuda.device(q.device):
            rc = native.library().pnp_flash_attention_mma_bwd(
                *(t.data_ptr() for t in (q, k, v, out, lse, dout, dq, dk,
                                         dv)),
                d_ws.data_ptr(), ds_ws.data_ptr(), B, S, T, H, Kv,
                int(causal), int(window), native.stream_of(q))
        native.check_launch(name, rc)
        launches += 1
    return dq, dk, dv
