"""Plain PyTorch versions the CUDA kernels are held against: SHA-256,
flash attention, the decay scan and the RWKV-6 recurrence.

SHA-256: 32-bit words live in int64 tensors masked to 32 bits after every operation
that can carry past them (``+``, ``<<``); ``~x`` is written ``x ^ MASK32``.
These functions run on any device. ``sha256_words_hashlib`` is the ground
truth both are checked against.

``flash_attention_ref`` is the function of the reference's Pallas flash
kernel and of ``repro.models.attention.chunked_attention``, written out
plainly in float32; ``flash_attention_lse_ref`` its rows' log-sum-exp,
and ``flash_attention_bwd_ref`` its gradients, step by step as the
backward kernel computes them. ``decay_scan_ref`` and ``wkv6_ref`` are the
reference's recurrences (``repro/kernels/ref.py``) as sequential loops
over time in float32; ``decay_scan_bwd_ref`` and ``wkv6_bwd_ref`` their
gradients, step by step in reverse as the backward kernels compute them.
These loops are the twins the card's kernels are held to.

``decay_scan_doubling`` and ``wkv6_chunked`` compute the same functions in
few operations (a log-depth doubling scan; chunks of 16 steps whose
relative decays are exps of differences of cumulative log-decays, each at
most 1). ``kernels/ops.py`` runs them on the CPU, where autograd
differentiates them, and so does the step's review, which traces the loss
on fake tensors: a loop of one step a token would trace tens of thousands
of operations at a full config's depth.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.native import MASK32

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19], dtype=np.uint32)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & MASK32


def bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte-swap each 32-bit word (little-endian words -> big-endian)."""
    return (((x << 24) & 0xFF000000) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | (x >> 24))


def sha256_pad_words(msg: torch.Tensor) -> torch.Tensor:
    """msg: (N, W) words -> padded blocks (N, nb*16) per FIPS 180-4.

    The message is the big-endian serialization of the W words."""
    n, w = msg.shape
    bit_len = w * 32
    nb = (bit_len + 1 + 64 + 511) // 512
    pad = torch.zeros((n, nb * 16 - w), dtype=torch.int64, device=msg.device)
    pad[:, 0] = 0x80000000
    pad[:, -1] = bit_len & MASK32
    pad[:, -2] = bit_len >> 32
    return torch.cat([msg.to(torch.int64), pad], dim=1)


def sha256_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """state: (N, 8) words; block: (N, 16) words -> (N, 8)."""
    w = list(block.unbind(1))
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK32)
    a, b, c, d, e, f, g, h = state.unbind(1)
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ MASK32) & g)
        t1 = (h + s1 + ch + int(_K[t]) + w[t]) & MASK32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = ((t1 + s0 + maj) & MASK32, a, b, c,
                                  (d + t1) & MASK32, e, f, g)
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=1)) & MASK32


def sha256_words_ref(msg: torch.Tensor) -> torch.Tensor:
    """msg: (N, W) words -> digest words (N, 8)."""
    padded = sha256_pad_words(msg)
    n = msg.shape[0]
    state = torch.as_tensor(_H0.astype(np.int64), device=msg.device) \
        .expand(n, 8)
    for b in range(padded.shape[1] // 16):
        state = sha256_compress(state, padded[:, b * 16:(b + 1) * 16])
    return state


def sha256_words_hashlib(msg: np.ndarray) -> np.ndarray:
    """Ground truth via hashlib: (N, W) words -> (N, 8) uint32 digests."""
    out = np.zeros((msg.shape[0], 8), np.uint32)
    for i, row in enumerate(np.asarray(msg, np.uint32)):
        dig = hashlib.sha256(row.astype(">u4").tobytes()).digest()
        out[i] = np.frombuffer(dig, ">u4")
    return out


# masked scores, as the reference's flash kernel writes them
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, Kv, hd) -> (B, S, H, hd) in q's dtype.

    float32 math, scores scaled by 1/sqrt(hd). With ``causal``, query s
    sees keys t <= s (absolute positions, queries at offset 0); with
    ``window > 0`` only keys t > s - window. Query head h reads KV head
    h // (H // Kv)."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if H % Kv:
        raise ValueError(f"flash_attention_ref: {H} heads over {Kv} KV heads")
    g = H // Kv
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kf) / hd ** 0.5
    if causal or window:
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(T, device=q.device)[None, :]
        keep = torch.ones(S, T, dtype=torch.bool, device=q.device)
        if causal:
            keep &= kp <= qp
        if window:
            keep &= kp > qp - window
        scores = scores.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vf).to(q.dtype)


def _scores_keep(q, k, causal: bool, window: int):
    """Scaled scores (B, H, S, T) in float32, K repeated over each KV
    head's query heads, and the mask's keep (S, T)."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if H % Kv:
        raise ValueError(f"flash attention: {H} heads over {Kv} KV heads")
    kf = k.float().repeat_interleave(H // Kv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kf) / hd ** 0.5
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    keep = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    return scores, keep


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool,
                            window: int = 0) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled, masked scores: float32 (B, H,
    S), natural-log units (what the training forward instance saves)."""
    scores, keep = _scores_keep(q, k, causal, window)
    return torch.logsumexp(scores.masked_fill(~keep, NEG_INF), dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool, window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """dq, dk, dv of ``flash_attention_ref`` at output ``o`` with row
    log-sum-exp ``lse`` (B, H, S) and output gradient ``do``, float32, in
    the backward kernel's steps: D = rowsum(do * o); P = exp(scores - lse)
    under the mask; dV = P^T dO; dP = dO V^T; dS = P (dP - D); dQ = dS K /
    sqrt(hd); dK = dS^T Q / sqrt(hd); dK and dV summed over each KV head's
    query heads."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    g = H // Kv
    scores, keep = _scores_keep(q, k, causal, window)
    p = torch.where(keep, torch.exp(scores - lse.float()[..., None]),
                    torch.zeros((), device=q.device))
    q32, o32, do32 = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    d = (do32 * o32).sum(-1).transpose(1, 2)                   # (B, H, S)
    dv = torch.einsum("bhst,bshd->bthd", p, do32)
    dp = torch.einsum("bshd,bthd->bhst", do32, vf)
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bhst,bthd->bshd", ds, kf) / hd ** 0.5
    dk = torch.einsum("bhst,bshd->bthd", ds, q32) / hd ** 0.5
    dk = dk.reshape(B, T, Kv, g, hd).sum(3)
    dv = dv.reshape(B, T, Kv, g, hd).sum(3)
    return dq, dk, dv


def decay_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over (B, S, C), from h0 (B, C) or zeros.
    float32 inside, returned in a's dtype."""
    a32, b32 = a.float(), b.float()
    h = (a32.new_zeros((a.shape[0], a.shape[2])) if h0 is None
         else h0.float())
    out = torch.empty_like(a32)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w: (B, S, H, K); v: (B, S, H, V); u: (H, K); s0: (B, H, K, V).
    Returns (out (B, S, H, V), s_final (B, H, K, V)), both float32:
    o_t = r_t^T (S + (u * k_t) v_t^T), then S <- diag(w_t) S + k_t v_t^T."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float().clone())
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    u32 = u.float()[None, :, :, None]
    out = torch.empty((B, S, H, V), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]
        out[:, t] = torch.einsum("bhk,bhkv->bhv", r32[:, t], s + u32 * kv)
        s = w32[:, t, :, :, None] * s + kv
    return out, s


def decay_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``decay_scan_ref``'s (h, h_last) from a (B, S, C), its
    output h, dh (B, S, C) and dh_last (B, C) or None (zeros), with h0 (B,
    C) or None (zeros) the start it ran from. Returns (da, db, dh0), float32:
    g_{S-1} = dh_{S-1} + dh_last, g_t = dh_t + a_{t+1} g_{t+1}; da_t = g_t
    h_{t-1} (h_{-1} = h0), db_t = g_t, dh0 = a_0 g_0, in the kernel's order
    of operations."""
    a32, h32, dh32 = a.float(), h.float(), dh.float()
    B, S, C = a.shape
    carry = (a32.new_zeros((B, C)) if dh_last is None
             else dh_last.float().clone())
    start = a32.new_zeros((B, C)) if h0 is None else h0.float()
    da, db = torch.empty_like(a32), torch.empty_like(a32)
    for t in range(S - 1, -1, -1):
        g = dh32[:, t] + carry
        db[:, t] = g
        da[:, t] = g * (h32[:, t - 1] if t else start)
        carry = a32[:, t] * g
    return da, db, carry


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                 ds_final: Optional[torch.Tensor] = None,
                 s0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``wkv6_ref``'s (out, s_final) from dout (B, S, H, V) and
    ds_final (B, H, K, V) or None (zeros). Returns (dr, dk, dv, dw, du),
    float32, du (H, K) summed over the batch: with the state S_{t-1} before
    step t and dS_t the gradient of the state after it, dr_t = S_{t-1} do_t
    + u k_t (v_t.do_t), dk_t = dS_t v_t + u r_t (v_t.do_t), dv_t = dS_t^T
    k_t + (sum_k r_t u k_t) do_t, dw_t = rowsum(dS_t S_{t-1}), then dS_{t-1}
    = diag(w_t) dS_t + r_t do_t^T."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    do32, u32 = dout.float(), u.float()
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float().clone())
    states = []
    for t in range(S):
        states.append(s)
        s = w32[:, t, :, :, None] * s + k32[:, t, :, :, None] * \
            v32[:, t, :, None, :]
    ds = (torch.zeros_like(s) if ds_final is None
          else ds_final.float().clone())
    dr, dk, dw = (torch.empty_like(r32) for _ in range(3))
    dv = torch.empty_like(v32)
    du = torch.zeros((B, H, K), dtype=torch.float32, device=r.device)
    for t in range(S - 1, -1, -1):
        rt, kt, vt, gt = r32[:, t], k32[:, t], v32[:, t], do32[:, t]
        p = (vt * gt).sum(-1, keepdim=True)                  # (B, H, 1)
        a = (rt * u32 * kt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", states[t], gt) + \
            u32 * kt * p
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", ds, vt) + u32 * rt * p
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", ds, kt) + a * gt
        dw[:, t] = (ds * states[t]).sum(-1)
        du = du + rt * kt * p
        ds = w32[:, t, :, :, None] * ds + rt[..., None] * gt[:, :, None, :]
    return dr, dk, dv, dw, du.sum(0)


def decay_scan_doubling(a: torch.Tensor, b: torch.Tensor,
                        h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``decay_scan_ref``'s function by log2(S) doubling steps (the
    reference's ``associative_scan`` algebra: (a1, b1) then (a2, b2) is (a1
    a2, a2 b1 + b2)); h0 (zeros if None) folds into step 0's b as the
    reference folds it, so a is in the graph at every S. float32 inside,
    returned in a's dtype."""
    A, h = a.float(), b.float()
    S = a.shape[1]
    if S:
        start = (A.new_zeros((a.shape[0], 1, a.shape[2])) if h0 is None
                 else h0.float()[:, None])
        h = torch.cat([h[:, :1] + A[:, :1] * start, h[:, 1:]], dim=1)
    off = 1
    while off < S:
        h = torch.cat([h[:, :off], h[:, off:] + A[:, off:] * h[:, :-off]],
                      dim=1)
        if 2 * off < S:
            A = torch.cat([A[:, :off], A[:, off:] * A[:, :-off]], dim=1)
        off *= 2
    return h.to(a.dtype)


# steps a chunk of ``wkv6_chunked``; a log-decay below LOG_W_MIN (w <
# 1e-26, whose contribution is below float32's resolution) is clamped so
# that a w that underflowed to 0 gives no inf - inf
WKV_CHUNK = 16
LOG_W_MIN = -60.0


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 s0: Optional[torch.Tensor] = None,
                 chunk: int = WKV_CHUNK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv6_ref``'s function in chunks of ``chunk`` steps: with c the
    cumulative log-decay inside a chunk, step t sees step tau < t of its
    chunk through exp(c_{t-1} - c_tau) and the chunk's start state through
    exp(c_{t-1}), each at most 1; one state update a chunk. float32."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    if S == 0:
        return torch.zeros((B, 0, H, V), dtype=torch.float32,
                           device=r.device), s.clone()
    L = chunk
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(x, fill):                   # (B, S, H, D) -> (B, H, nc, L, D)
        x = x.float()
        if pad:
            x = torch.cat([x, x.new_full((B, pad) + x.shape[2:], fill)], 1)
        return x.reshape(B, nc, L, H, x.shape[-1]).permute(0, 3, 1, 2, 4)
    rc, kc, vc, wc = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0), \
        chunks(w, 1.0)
    lw = torch.log(wc).clamp(min=LOG_W_MIN)
    c = torch.cumsum(lw, dim=3)            # through step t
    cp = c - lw                            # through step t - 1
    before = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)
    diff = torch.where(before[:, :, None], cp[..., :, None, :]
                       - c[..., None, :, :], float("-inf"))
    att = (rc[..., :, None, :] * kc[..., None, :, :]
           * torch.exp(diff)).sum(-1)     # (B, H, nc, L, L)
    bonus = (rc * u.float()[None, :, None, None, :] * kc).sum(-1)
    out = att @ vc + bonus[..., None] * vc
    rq = rc * torch.exp(cp)
    kd = kc * torch.exp(c[..., -1:, :] - c)
    added = kd.transpose(-1, -2) @ vc      # (B, H, nc, K, V)
    decay = torch.exp(c[..., -1, :])[..., None]
    inter = []
    for n in range(nc):
        inter.append(rq[:, :, n] @ s)
        s = decay[:, :, n] * s + added[:, :, n]
    out = out + torch.stack(inter, dim=2)
    out = out.permute(0, 2, 3, 1, 4).reshape(B, nc * L, H, V)[:, :S]
    return out, s
