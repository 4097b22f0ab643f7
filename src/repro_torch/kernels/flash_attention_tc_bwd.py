"""Binding of the hand-written bfloat16 attention backward
(``csrc/flash_attention_tc_bwd.cu``): dQ, dK and dV of the attention the
tensor-core flash kernel computes, with every product on the tensor cores
(``mma.sync`` bf16, float32 accumulators).

The reference has no Pallas backward (``jax.grad`` differentiates
``repro.models.attention.chunked_attention``); the port's bf16 training
step reaches this through ``flash_attention.FlashAttention``. Three kernel
launches a chunk of batch rows: D = rowsum(dO o); dK and dV a key tile,
which also stores the pairs' dS^T in a workspace; dQ = dS K a query tile.
Every sum runs in a fixed order (no atomics), so two calls give the same
bits. Plain version: ``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import native

HEAD_DIMS = (64, 128)
TILE = 64           # query rows and keys a tile (constants in the source)

# Calls of the backward since the last reset (each launches its three
# kernels once a chunk of batch rows); only the call below adds to it.
launches = 0

# The most device memory a chunk's dS^T workspace takes: past it the batch
# rows go in chunks, three launches each. Rows are independent, so the
# chunks do not change a bit of the result. 2 GiB holds qwen3-0.6b's
# prefill shape (B 8, S = T 2048, 16 heads: 1.07 GB) in one chunk.
DS_CAP_BYTES = 2 << 30


def tile(head_dim: int) -> dict:
    """The backward's tiles at ``head_dim`` and what the runtime reports
    for each of its kernels: registers a thread and local (spilled)
    bytes."""
    import ctypes
    out = (ctypes.c_int32 * 10)()
    native.check_launch("flash_attention_tc_bwd tile",
                        native.library().pnp_flash_attention_tc_bwd_info(
                            head_dim, out))
    res = {"block_rows": out[0], "block_keys": out[1],
           "dkv_shared_bytes": out[2], "dq_shared_bytes": out[3]}
    for name, at in (("dot_kernel", 4), ("dkv_kernel", 6), ("dq_kernel", 8)):
        res[name + "_resources"] = {"registers": out[at],
                                    "local_bytes": out[at + 1]}
    return res


def _padded(n: int) -> int:
    return -(-n // TILE) * TILE


def rows_a_chunk(S: int, T: int, H: int) -> int:
    """Batch rows a launch takes: as many as keep the dS^T workspace under
    ``DS_CAP_BYTES``, at least one."""
    return max(1, DS_CAP_BYTES // (H * _padded(T) * _padded(S) * 2))


def flash_attention_tc_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, out: torch.Tensor,
                                lse: torch.Tensor, dout: torch.Tensor, *,
                                causal: bool, window: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """q, out, dout (B, S, H, hd) and k, v (B, T, Kv, hd) bfloat16; lse (B,
    H, S) float32, the training forward's row log-sum-exp; contiguous, on
    one CUDA card, hd in ``HEAD_DIMS`` -> (dq, dk, dv) like q, k, v, in
    bfloat16. Raises for any other input: there is no fallback."""
    global launches
    native.check_qkv("flash_attention_tc_bwd_cuda", q, k, v, window,
                     (torch.bfloat16,), HEAD_DIMS)
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    for name, t, shape, dtype in (
            ("out", out, q.shape, torch.bfloat16),
            ("dout", dout, q.shape, torch.bfloat16),
            ("lse", lse, (B, H, S), torch.float32)):
        if (not t.is_cuda or t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"flash_attention_tc_bwd_cuda: {name} must be a contiguous "
                f"{dtype} {tuple(shape)} tensor on {q.device}, 16-byte "
                f"aligned, got {t.dtype} {tuple(t.shape)} on {t.device}")
    dq = torch.empty_like(q)
    # with no query, no key gets a gradient, and no kernel runs
    alloc = torch.empty_like if B and S else torch.zeros_like
    dk, dv = alloc(k), alloc(v)
    if B and S:
        lib = native.library()
        rows = min(B, rows_a_chunk(S, T, H))
        d_ws = torch.empty((rows, H, S), dtype=torch.float32,
                           device=q.device)
        ds_ws = torch.empty((rows, H, _padded(T), _padded(S)),
                            dtype=torch.bfloat16, device=q.device)
        with torch.cuda.device(q.device):
            for b0 in range(0, B, rows):
                n = min(rows, B - b0)
                rc = lib.pnp_flash_attention_tc_bwd(
                    *(t[b0].data_ptr() for t in (q, k, v, out, lse, dout,
                                                 dq, dk, dv)),
                    d_ws.data_ptr(), ds_ws.data_ptr(), n, S, T, H, Kv, hd,
                    int(causal), int(window), native.stream_of(q))
                native.check_launch("flash_attention_tc_bwd_cuda", rc)
        launches += 1
    return dq, dk, dv
