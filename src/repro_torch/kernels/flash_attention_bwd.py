"""Binding of the hand-written attention backward
(``csrc/flash_attention_bwd.cu``): dQ, dK and dV of the attention the
CUDA-core flash kernel computes, in float32 on the CUDA cores.

The reference has no Pallas backward (``jax.grad`` differentiates
``repro.models.attention.chunked_attention``); the port's training step
reaches this through ``flash_attention.FlashAttention``. Three kernel
launches a call: D = rowsum(dO o); dK and dV a key tile, which also
stores the tile's dS in the workspace; dQ = dS K a query tile (past 2 GiB
of dS the key tiles go in chunks, two launches each). Every sum runs in a
fixed order (no atomics), so two calls give the same bits. The kernels
fill every output element and their workspace themselves, so all are
allocated with ``torch.empty``. Plain version:
``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import native

HEAD_DIMS = (16, 32, 64, 128)

# Calls of the backward since the last reset (each launches its kernels);
# only the call below adds to it.
launches = 0

# the most device memory a call's dS tiles take (the workspace); past it the
# key tiles go in chunks, each a launch of the dK/dV and the dQ kernels. It
# is fixed, not read from the card's free memory: the chunks set the order
# of dQ's sum, so a cap that followed what else the card holds would let a
# miner and its verifier get different bits. 2 GiB holds qwen3-0.6b's
# float32 shape (1.1 GB of dS) in one chunk; PERF.md has what chunks cost.
DS_CAP_BYTES = 2 << 30


def tile(head_dim: int) -> dict:
    """The backward's tiles at ``head_dim`` (constants in its source) and
    what the runtime reports for each of its kernels: registers a thread
    and local (spilled) bytes."""
    import ctypes
    out = (ctypes.c_int32 * 14)()
    native.check_launch("flash_attention_bwd tile",
                        native.library().pnp_flash_attention_bwd_info(
                            head_dim, out))
    res = {"dq_kernel": {"warps": out[0], "block_rows": out[1],
                         "block_keys": out[2], "stages": out[3]},
           "dkv_kernel": {"warps": out[4], "block_keys": out[5],
                          "block_rows": out[6], "stages": out[7]}}
    for name, at in (("dot_kernel", 8), ("dq_kernel", 10),
                     ("dkv_kernel", 12)):
        if out[at] >= 0:
            res[name + "_resources"] = {"registers": out[at],
                                        "local_bytes": out[at + 1]}
    return res


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
            f"flash_attention_bwd_cuda: {q.dtype}; this backward is float32 "
            "only (bf16 runs flash_attention_tc_bwd's)")
    native.check_qkv("flash_attention_bwd_cuda", q, k, v, window,
                     {torch.float32: 0}, HEAD_DIMS)
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (B, H, S))):
        if (not t.is_cuda or t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
                or (name != "lse" and t.data_ptr() % 16)):
            raise ValueError(
                f"flash_attention_bwd_cuda: {name} must be a contiguous "
                f"float32 {tuple(shape)} tensor on {q.device} (out and "
                f"dout on a 16-byte boundary), got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    dq = torch.empty_like(q)
    # with no query, no key gets a gradient, and no kernel runs
    alloc = torch.empty_like if B and S else torch.zeros_like
    dk, dv = alloc(k), alloc(v)
    if B and S:
        lib = native.library()
        workspace = torch.empty(
            lib.pnp_flash_attention_bwd_workspace_words(
                B, S, T, H, hd, int(causal), int(window), DS_CAP_BYTES),
            dtype=torch.int32, device=q.device)
        with torch.cuda.device(q.device):
            rc = lib.pnp_flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), workspace.data_ptr(), B, S, T,
                H, Kv, hd, int(causal), int(window), DS_CAP_BYTES,
                native.stream_of(q))
        launches += 1
        native.check_launch("flash_attention_bwd_cuda", rc)
    return dq, dk, dv
