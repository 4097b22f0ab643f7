"""Binding of the hand-written bfloat16 attention backward
(``csrc/flash_attention_tc_bwd.cu``): dQ, dK and dV of the attention the
tensor-core flash kernel computes, with every product on Hopper's tensor
cores (``wgmma`` bf16, float32 accumulators).

The reference has no Pallas backward (``jax.grad`` differentiates
``repro.models.attention.chunked_attention``); the port's bf16 training
step reaches this through ``flash_attention.FlashAttention``. Two kernel
launches a call: D = rowsum(dO o) (with the log-sum-exp in log2 units)
into two small workspaces; then one persistent launch over two kinds of
item, dK and dV of a block of keys and dQ of a block of query rows, which
recomputes the scores instead of keeping dS: no S x S workspace. The items
are listed here, heaviest first (``schedule``). Every sum runs in a fixed
order (no atomics), so two calls give the same bits. Plain version:
``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import native

HEAD_DIMS = (64, 128)
TILE = 64           # rows of the tiles the mask's rule picks (the source's)

# Calls of the backward since the last reset (each launches its two
# kernels once); only the call below adds to it.
launches = 0

_TILES: Dict[int, dict] = {}
_SCHEDULES: Dict[tuple, torch.Tensor] = {}


def tile(head_dim: int) -> dict:
    """The backward's tile at ``head_dim`` and what the runtime reports for
    each of its kernels: registers a thread and local (spilled) bytes."""
    if head_dim not in _TILES:
        import ctypes
        out = (ctypes.c_int32 * 11)()
        native.check_launch("flash_attention_tc_bwd tile",
                            native.library().pnp_flash_attention_tc_bwd_info(
                                head_dim, out))
        res = {"item_rows": out[0], "stages": out[1],
               "resident_buffers": out[2], "shared_bytes": out[3],
               "consumer_registers": out[4], "producer_registers": out[5],
               "blocks_an_sm": out[6]}
        for name, at in (("dot_kernel", 7), ("bwd_kernel", 9)):
            res[name + "_resources"] = {"registers": out[at],
                                        "local_bytes": out[at + 1]}
        _TILES[head_dim] = res
    return _TILES[head_dim]


def visible_tiles(S: int, T: int, causal: bool, window: int) -> np.ndarray:
    """(ceil(S / 64), ceil(T / 64)) bool: whether the tile of 64 query rows
    and 64 keys holds a pair inside the mask's band (the kernel's
    ``visible``)."""
    q0 = np.arange(-(-S // TILE)) * TILE
    k0 = np.arange(-(-T // TILE)) * TILE
    q_last = np.minimum(q0 + TILE, S) - 1
    k_last = np.minimum(k0 + TILE, T) - 1
    vis = np.ones((q0.size, k0.size), dtype=bool)
    if causal:
        vis &= k0[None, :] <= q_last[:, None]
    if window > 0:
        vis &= k_last[None, :] > q0[:, None] - window
    return vis


def schedule(B: int, S: int, T: int, H: int, Kv: int, causal: bool,
             window: int, rows: int) -> np.ndarray:
    """The persistent launch's items, heaviest first, as (n, 2) int32: x =
    2 tile + kind (0: dK and dV of keys [rows tile, rows tile + rows) of
    one KV head; 1: dQ of query rows [rows tile, ...) of one head), y =
    head | batch row << 16. Each item appears once. An item's weight is
    its products of 64 x 64 x hd: 4 for each (64 keys, 64 query rows,
    head) tile a dK/dV warpgroup computes, 3 for each a dQ warpgroup
    computes. Ties keep the order (kind, tile, batch row, head)."""
    G, per = H // Kv, rows // TILE
    vis = visible_tiles(S, T, causal, window)
    n_kv, n_q = -(-T // rows), -(-S // rows)
    k_tiles = np.pad(vis.sum(0), (0, n_kv * per - vis.shape[1]))
    q_tiles = np.pad(vis.sum(1), (0, n_q * per - vis.shape[0]))
    w_kv = 4 * G * k_tiles.reshape(n_kv, per).sum(1)
    w_q = 3 * q_tiles.reshape(n_q, per).sum(1)
    kv = np.stack(np.meshgrid(np.arange(n_kv), np.arange(B), np.arange(Kv),
                              indexing="ij"), -1).reshape(-1, 3)
    qq = np.stack(np.meshgrid(np.arange(n_q), np.arange(B), np.arange(H),
                              indexing="ij"), -1).reshape(-1, 3)
    x = np.concatenate([2 * kv[:, 0], 2 * qq[:, 0] + 1])
    y = np.concatenate([kv[:, 2] | kv[:, 1] << 16, qq[:, 2] | qq[:, 1] << 16])
    weight = np.concatenate([w_kv[kv[:, 0]], w_q[qq[:, 0]]])
    order = np.argsort(-weight, kind="stable")
    return np.stack([x[order], y[order].astype(np.uint32).view(np.int32)],
                    1).astype(np.int32)


def _schedule_on(device: torch.device, *key) -> torch.Tensor:
    """``schedule(*key)`` on ``device``, made once for each shape."""
    k = (device, *key)
    if k not in _SCHEDULES:
        _SCHEDULES[k] = torch.from_numpy(schedule(*key)).to(device)
    return _SCHEDULES[k]


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
        rows = tile(hd)["item_rows"]
        s_pad = -(-S // rows) * rows
        items = _schedule_on(q.device, B, S, T, H, Kv, bool(causal),
                             int(window), rows)
        # D and the log-sum-exp in log2 units, (B, H, S_pad) each
        ws = torch.empty((2, B, H, s_pad), dtype=torch.float32,
                         device=q.device)
        with torch.cuda.device(q.device):
            rc = lib.pnp_flash_attention_tc_bwd(
                *(t.data_ptr() for t in (q, k, v, out, lse, dout, dq, dk, dv,
                                         ws[0], ws[1], items)),
                items.shape[0], B, S, T, H, Kv, hd, int(causal), int(window),
                native.stream_of(q))
            native.check_launch("flash_attention_tc_bwd_cuda", rc)
        launches += 1
    return dq, dk, dv
