"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a card. Without one every test here skips.

This file imports no JAX, so it also runs on a machine that has only the
port's dependencies::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import runpy
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (decay_scan, flash_attention,  # noqa: E402
                                 flash_attention_tc, merkle, native, ops, ref,
                                 sha256, wkv6)

pytestmark = pytest.mark.cuda

# seconds of quiet at each end of a profiled window
PROFILER_QUIET_S = 0.02


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(shape, seed):
    rng = np.random.RandomState(seed)
    w = rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.int64)
    w.flat[0] = 2**32 - 1
    w.flat[-1] = 2**31
    return torch.from_numpy(w)


@pytest.mark.parametrize("n,w", [(1, 1), (7, 4), (128, 12), (200, 13),
                                 (64, 14), (16, 20), (3, 32), (4097, 2)])
@pytest.mark.parametrize("outputs", [(True, True), (True, False),
                                     (False, True)])
def test_sha256_kernel_matches_plain_version(card, n, w, outputs):
    msg = _words((n, w), n * 31 + w)
    raw, bswap = outputs
    before = sha256.launches
    got = sha256.sha256_rows_cuda(msg.to(card), raw=raw, bswap=bswap)
    torch.cuda.synchronize()
    assert sha256.launches == before + 1
    want = (ref.sha256_words_ref(msg) if raw else None,
            ref.sha256_words_ref(ref.bswap32(msg)) if bswap else None)
    for g, r in zip(got, want):
        assert (g is None) == (r is None)
        if r is not None:
            assert torch.equal(g.cpu(), r)
    np.testing.assert_array_equal(
        got[0].cpu().numpy() if raw else got[1].cpu().numpy(),
        ref.sha256_words_hashlib(
            msg.numpy() if raw else ref.bswap32(msg).numpy()))


def _hashlib_rows(msg):
    return ref.sha256_words_hashlib(msg.numpy())


@pytest.mark.parametrize("w", range(1, 21))
def test_sha256_kernel_equals_hashlib_across_padding_edges(card, w):
    # W 13/14 put the message at 52/56 bytes, either side of the 55-byte
    # edge where the length needs a second block; N is not a multiple of
    # the kernel's block of 64 rows; words span [0, 2**32) as int64, no
    # conversion on the way in
    n = 64 * 3 + 17
    msg = _words((n, w), 1000 + w)
    want_raw = _hashlib_rows(msg)
    want_bsw = _hashlib_rows(ref.bswap32(msg))
    for raw, bswap in ((True, True), (True, False), (False, True)):
        got_raw, got_bsw = sha256.sha256_rows_cuda(msg.to(card), raw=raw,
                                                   bswap=bswap)
        if raw:
            np.testing.assert_array_equal(got_raw.cpu().numpy(), want_raw)
        if bswap:
            np.testing.assert_array_equal(got_bsw.cpu().numpy(), want_bsw)


_FLAT = 3 * 1000 * 4 + 1


@pytest.mark.parametrize("view", [
    lambda f: f[:-1].view(-1, 4), lambda f: f[1:].view(-1, 4),
    lambda f: f[:3 * 1000 * 3].view(-1, 9), lambda f: f[1:8001].view(-1, 2),
    lambda f: f[1:8001].view(-1, 8)],
    ids=["w4", "w4-unaligned", "w9", "w2-unaligned", "w8-unaligned"])
def test_sha256_kernel_unaligned_rows(card, view):
    # a view that starts 8 bytes past a 16-byte boundary takes the 8-byte
    # loads (also at W = 2 and 8, whose instances fix W), as does odd W
    msg = view(_words((_FLAT,), 65).to(card))
    got = sha256.sha256_rows_cuda(msg, raw=True, bswap=True)
    np.testing.assert_array_equal(got[0].cpu().numpy(),
                                  _hashlib_rows(msg.cpu()))
    np.testing.assert_array_equal(
        got[1].cpu().numpy(), _hashlib_rows(ref.bswap32(msg.cpu())))


def test_sha256_no_rows_launches_nothing(card):
    before = sha256.launches
    raw, bswap = sha256.sha256_rows_cuda(
        torch.zeros((0, 5), dtype=torch.int64, device=card), raw=True,
        bswap=True)
    assert sha256.launches == before
    assert raw.shape == bswap.shape == (0, 8)
    assert raw.dtype == bswap.dtype == torch.int64


def test_sha256_call_is_one_kernel(card):
    from torch.profiler import ProfilerActivity, profile
    msg = _words((1 << 16, 2), 7).to(card)
    sha256.sha256_rows_cuda(msg, raw=True, bswap=True)
    torch.cuda.synchronize()
    # the profiler drops a kernel whose timestamp lands just outside its
    # window, as one launched at once after the session starts or one the
    # session stops at once after (chip_probes.py profiler_count counts how
    # often): quiet time at both ends keeps the three kernels inside
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_QUIET_S)
        for _ in range(3):
            sha256.sha256_rows_cuda(msg, raw=True, bswap=True)
        torch.cuda.synchronize()
        time.sleep(PROFILER_QUIET_S)
    kernels = [e.name for e in prof.events()
               if e.device_type.name == "CUDA"]
    assert len(kernels) == 3 and all("sha256_rows_kernel" in k
                                     for k in kernels), kernels


def _digests(shape, seed):
    return _words(shape, seed).to(torch.int32)   # uint32 bits as int32


# (B, n): no level (n <= 64), one level, odd widths, one unit of 1,024
# nodes and the next, and reductions whose units meet (n > 64 x 1,024)
# with ragged tails, forests of 2-4 trees
MERKLE_CASES = [(1, 1), (1, 2), (1, 65), (1, 4097), (3, 300), (1, 1024),
                (1, 1025), (2, 2049), (1, (1 << 16) + 1), (4, 1 << 16),
                (3, 3 * (1 << 14) + 5), (2, (1 << 17) + 3)]


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("B,n", MERKLE_CASES)
def test_merkle_kernel_matches_plain_version(card, B, n, keep):
    d = _digests((B, n, 8), B * n)
    before = merkle.launches
    got = merkle.merkle_reduce(d.to(card), keep_levels=keep)
    torch.cuda.synchronize()
    # one launch a reduction, none where there is nothing to reduce
    assert merkle.launches == before + (n > merkle._CUTOVER)
    want = merkle._reduce_ref(d.to(card), keep)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # no atomics in the sums: a second launch gives the same bits
    again = merkle.merkle_reduce(d.to(card), keep_levels=keep)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_merkle_workspace_counters_end_zero(card):
    B, n = 2, (1 << 17) + 3
    d = _digests((B, n, 8), 3).to(card)
    for keep in (False, True):
        merkle.merkle_reduce(d, keep_levels=keep)
        torch.cuda.synchronize()
        counters, _ = merkle._workspace[(d.device.index,
                                         native.stream_of(d))]
        assert native.library().pnp_merkle_workspace_words(B, n, 64, 1) > 0
        assert int(counters.count_nonzero()) == 0


def test_merkle_reductions_share_the_workspace_in_any_order(card):
    # a reduction with few tickets and many scratch nodes, then one with
    # more tickets: the second must find its tickets zero
    small = _digests((1, 1 << 20, 8), 5).to(card)
    large = _digests((8, 1 << 18, 8), 6).to(card)
    lib = native.library()
    assert lib.pnp_merkle_workspace_words(8, 1 << 18, 64, 1) > \
        lib.pnp_merkle_workspace_words(1, 1 << 20, 64, 1)
    for d in (small, large, small):
        got = merkle.merkle_reduce(d)
        torch.cuda.synchronize()
        assert torch.equal(got[-1], merkle._reduce_ref(d, False)[-1])


def test_wrappers_refuse_bad_input(card):
    with pytest.raises(TypeError, match="int64"):
        sha256.sha256_rows_cuda(torch.zeros((2, 2), dtype=torch.int32,
                                            device=card))
    with pytest.raises(ValueError, match="contiguous"):
        sha256.sha256_rows_cuda(torch.zeros((4, 4), dtype=torch.int64,
                                            device=card)[:, ::2])
    with pytest.raises(ValueError, match=r"\(B, n, 8\)"):
        merkle.merkle_reduce(torch.zeros((1, 100, 7), dtype=torch.int32,
                                         device=card))
    with pytest.raises(TypeError, match="int32"):
        merkle.merkle_reduce(torch.zeros((1, 100, 8), dtype=torch.int64,
                                         device=card))
    with pytest.raises(ValueError, match="contiguous"):
        merkle.merkle_reduce(torch.zeros((1, 100, 16), dtype=torch.int32,
                                         device=card)[..., ::2])


# chip_smoke.py's flash_vs_plain cases: (hd, G, causal, S, T)
FLASH_CASES = [(hd, g, causal, n, n) for hd in (32, 64, 128)
               for g in (1, 2) for causal in (True, False)
               for n in (33, 1000, 2048)]
FLASH_CASES += [(hd, 2, False, 700, 1500) for hd in (32, 64, 128)]
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _flash_counters(dtype, hd):
    """(the launch counter of the kernel a call must take, the other's):
    the tensor-core kernel for bf16 at head dims 64, 80, 128 and 256, the
    CUDA-core kernel for the rest."""
    if dtype == torch.bfloat16 and hd in (64, 80, 128, 256):
        return flash_attention_tc, flash_attention
    return flash_attention, flash_attention_tc


def _qkv(hd, g, s, t, dtype, card, seed, b=2, kv=2):
    gen = torch.Generator(device=card).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)
    return randn(b, s, kv * g, hd), randn(b, t, kv, hd), randn(b, t, kv, hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,g,causal,s,t", FLASH_CASES)
def test_flash_kernel_matches_plain_version(card, dtype, hd, g, causal, s, t):
    q, k, v = _qkv(hd, g, s, t, dtype, card, hd + 7 * s + t)
    used, other = _flash_counters(dtype, hd)
    before, other_before = used.launches, other.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (used.launches, other.launches) == (before + 1, other_before)
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # one block owns each row and sums in a fixed order: run to run equal
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal), got)


@pytest.mark.parametrize("edge", ["rows+1", "rows-1", "keys-1", "keys+1",
                                  "2keys+1"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_cuda_core_kernel_tile_edges(card, hd, causal, edge):
    # S and T one off the CUDA-core kernel's block of query rows and its
    # tile of keys, float32 (its path), GQA 2
    tile = flash_attention.tile(hd)
    bq, bk = tile["block_rows"], tile["block_keys"]
    s, t = {"rows+1": (bq + 1, bq + 1), "rows-1": (bq - 1, bq + 3),
            "keys-1": (bq + 1, bk - 1), "keys+1": (bk + 1, bk + 1),
            "2keys+1": (2 * bq + 5, 2 * bk + 1)}[edge]
    if causal:
        t = s
    q, k, v = _qkv(hd, 2, s, t, torch.float32, card, hd + s + t, b=2)
    before = flash_attention.launches
    got = flash_attention.flash_attention_cuda_core(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(flash_attention.flash_attention_cuda_core(
        q, k, v, causal=causal), got)


def test_flash_cuda_core_tile_fits_and_spills_nothing(card):
    for hd in flash_attention.HEAD_DIMS:
        tile = flash_attention.tile(hd)
        assert tile["shared_bytes"] <= 227 * 1024
        assert tile["block_rows"] % 16 == 0 and tile["block_keys"] % 8 == 0
        assert tile["registers"] <= 255
        if hd <= 128:
            assert tile["local_bytes"] == 0, tile


def test_flash_kernel_online_softmax_stability(card):
    q = torch.full((1, 32, 1, 32), 30.0, device=card)
    out = ops.flash_attention(q, q.clone(), torch.ones_like(q), causal=True)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, torch.ones_like(out), rtol=1e-5, atol=0)


def test_flash_wrapper_refuses_bad_input(card):
    q = torch.zeros(1, 8, 2, 32, device=card)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(q, q.cpu(), q, causal=True)
    with pytest.raises(ValueError, match="head_dim 48"):
        z = torch.zeros(1, 8, 2, 48, device=card)
        flash_attention.flash_attention_cuda(z, z, z, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        w = torch.zeros(1, 8, 2, 64, device=card)[..., ::2]
        flash_attention.flash_attention_cuda(w, w, w, causal=True)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        flash_attention.flash_attention_cuda(q.half(), q.half(), q.half(),
                                             causal=True)


# chip_smoke.py's flash window cases at recurrentgemma's head shape (hd 256,
# ten query heads over one KV head), with ragged S, and the reduced model's
FLASH_WINDOW_CASES = [(256, 10, 1, w, n) for w in (0, 64, 2048)
                      for n in (33, 1000, 2500)]
FLASH_WINDOW_CASES += [(32, 8, 1, 64, 200), (64, 2, 2, 100, 333),
                       (128, 2, 2, 64, 130)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,g,kv,window,n", FLASH_WINDOW_CASES)
def test_flash_kernel_window_matches_plain_version(card, dtype, hd, g, kv,
                                                   window, n):
    q, k, v = _qkv(hd, g, n, n, dtype, card, hd + window + n, b=1, kv=kv)
    used, other = _flash_counters(dtype, hd)
    before, other_before = used.launches, other.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert (used.launches, other.launches) == (before + 1, other_before)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(ops.flash_attention(q, k, v, causal=True,
                                           window=window), got)


# The tensor-core kernel's edges at the two served head shapes, cut to one
# batch row: qwen3-0.6b's (16 query heads over 8 KV heads, hd 128) and
# recurrentgemma-2b's (10 over 1, hd 256, window 2048): (hd, G, Kv, causal,
# window, S, T)
FLASH_TC_EDGE_CASES = [
    (128, 2, 8, True, 0, 1000, 1000),      # S not a multiple of 128 rows
    (128, 2, 8, True, 0, 50, 50),          # T under one 128-key tile
    (128, 2, 8, False, 0, 77, 1100),       # S != T, not causal
    (128, 2, 8, False, 0, 1100, 100),      # T under one tile, S > T
    (256, 10, 1, True, 2048, 2100, 2100),  # ragged S; window edge in tiles
    (256, 10, 1, True, 2048, 40, 40),      # T under one 64-key tile
    (256, 10, 1, False, 0, 300, 1000),     # S != T, not causal
    (256, 10, 1, True, 1000, 1500, 1500),  # window 1000: edge mid-tile
    (64, 2, 2, True, 100, 333, 333),       # hd 64, window 100
    # head dim 80 (stablelm-3b; the hd-128 pipeline on zero-filled columns)
    (80, 1, 4, True, 0, 1000, 1000),       # causal, ragged, G 1
    (80, 4, 2, False, 0, 129, 127),        # S and T one off a tile, G 4
    (80, 1, 2, False, 0, 700, 1500),       # S != T both ways
    (80, 1, 2, False, 0, 1500, 700),
    (80, 2, 2, True, 64, 300, 300),        # a window
    # the cross-attention's shapes: whisper's (16 heads, hd 64) at a decode
    # step and at prefill, llama-3.2-vision's (32 over 8) at a decode step
    (64, 1, 16, False, 0, 1, 1500),
    (64, 1, 16, False, 0, 416, 1500),
    (128, 4, 8, False, 0, 1, 1601),
    (128, 7, 8, True, 0, 300, 300),        # G 7: arctic's 56 heads over 8
]


@pytest.mark.parametrize("hd,g,kv,causal,window,s,t", FLASH_TC_EDGE_CASES)
def test_flash_tensor_core_kernel_edges(card, hd, g, kv, causal, window, s,
                                        t):
    q, k, v = _qkv(hd, g, s, t, torch.bfloat16, card, hd + window + s + t,
                   b=1, kv=kv)
    before, core = flash_attention_tc.launches, flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_tc.launches == before + 1
    assert flash_attention.launches == core
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal,
                                           window=window), got)


def test_flash_tensor_core_wrapper_refuses_misaligned_views(card):
    # a contiguous view that starts 2 bytes into its buffer: TMA needs a
    # base address on a 16-byte boundary
    buf = torch.zeros(1 + 64 * 2 * 64, dtype=torch.bfloat16, device=card)
    q = buf[1:].view(1, 64, 2, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = flash_attention_tc.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_tc.flash_attention_tc_cuda(q, q, q, causal=True)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.flash_attention(q, q, q, causal=True)
    with pytest.raises(TypeError, match="bfloat16"):
        z = torch.zeros(1, 8, 2, 64, device=card)
        flash_attention_tc.flash_attention_tc_cuda(z, z, z, causal=True)
    with pytest.raises(ValueError, match="head_dim 32"):
        z = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16, device=card)
        flash_attention_tc.flash_attention_tc_cuda(z, z, z, causal=True)
    assert flash_attention_tc.launches == before


DECAY_TOL = dict(rtol=1e-5, atol=1e-5)


def _decay_inputs(b, s, c, card, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    a = torch.rand((b, s, c), generator=gen, device=card) * 0.7 + 0.3
    x = torch.randn((b, s, c), generator=gen, device=card)
    h0 = torch.randn((b, c), generator=gen, device=card)
    return a, x, h0


@pytest.mark.parametrize("c", [1, 129, 2560])
@pytest.mark.parametrize("s", [1, 37, 300])
@pytest.mark.parametrize("with_h0", [True, False])
def test_decay_scan_kernel_matches_plain_version(card, c, s, with_h0):
    a, x, h0 = _decay_inputs(2, s, c, card, c + s)
    h0 = h0 if with_h0 else None
    before = decay_scan.launches
    got, got_last = ops.decay_scan(a, x, h0)
    torch.cuda.synchronize()
    assert decay_scan.launches == before + 1
    want = ref.decay_scan_ref(a, x, h0)
    torch.testing.assert_close(got, want, **DECAY_TOL)
    torch.testing.assert_close(got_last, want[:, -1], **DECAY_TOL)
    assert torch.equal(ops.decay_scan(a, x, h0)[0], got)


def test_decay_scan_chunked_equals_whole(card):
    a, x, h0 = _decay_inputs(3, 100, 130, card, 5)
    whole, whole_last = ops.decay_scan(a, x, h0)
    before = decay_scan.launches
    parts, parts_last = ops.decay_scan(a, x, h0, seq_chunk=16)
    assert decay_scan.launches == before + 7
    torch.testing.assert_close(parts, whole, **DECAY_TOL)
    torch.testing.assert_close(parts_last, whole_last, **DECAY_TOL)


# the tiled kernel's chunk and tile edges: S in {0, 1, L - 1, L, L + 1,
# 2L + 3} for its chunk of L = 128 steps (STEPS in decay_scan.cu), C across
# its 64-channel tiles
_L = 128


@pytest.mark.parametrize("c", [1, 31, 33, 129, 2560])
@pytest.mark.parametrize("s", [0, 1, _L - 1, _L, _L + 1, 2 * _L + 3])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("b", [1, 8])
def test_decay_scan_tiles_equal_one_thread_a_chain(card, b, c, s, with_h0):
    a, x, h0 = _decay_inputs(b, s, c, card, 7 * c + s + b)
    h0 = h0 if with_h0 else None
    got, got_last = decay_scan.decay_scan_cuda(a, x, h0)
    again, again_last = decay_scan.decay_scan_cuda(a, x, h0)
    chain, chain_last = decay_scan.decay_scan_cuda_per_chain(a, x, h0)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got_last, again_last)
    assert torch.equal(got, chain) and torch.equal(got_last, chain_last)
    want = ref.decay_scan_ref(a, x, h0)
    want_last = want[:, -1] if s else (
        h0 if with_h0 else torch.zeros_like(got_last))
    torch.testing.assert_close(got, want, **DECAY_TOL)
    torch.testing.assert_close(got_last, want_last, **DECAY_TOL)


@pytest.mark.parametrize("offset", [0, 1])
def test_decay_scan_tiles_unaligned_rows(card, offset):
    # a view 4 bytes past a 16-byte boundary (C % 4 == 0) takes the 4-byte
    # copies and gives the same bits as the aligned 16-byte ones
    _, x, h0 = _decay_inputs(3, 300, 260, card, 5)
    flat = torch.rand(3 * 300 * 260 + 1, device=card) * 0.7 + 0.3
    av = flat[offset:offset + 3 * 300 * 260].view(3, 300, 260)
    want, want_last = decay_scan.decay_scan_cuda_per_chain(av, x, h0)
    got, got_last = decay_scan.decay_scan_cuda(av, x, h0)
    assert torch.equal(got, want) and torch.equal(got_last, want_last)


def test_decay_scan_workspace_is_left_zero(card):
    # a launch leaves its ticket and carries zero, so launches of other
    # shapes on the same stream follow it
    a, x, h0 = _decay_inputs(8, 1000, 2560, card, 11)
    decay_scan.decay_scan_cuda(a, x, h0)
    small = _decay_inputs(1, 300, 33, card, 12)
    decay_scan.decay_scan_cuda(*small)
    torch.cuda.synchronize()
    ws = decay_scan._workspace[(card.index or 0,
                                torch.cuda.current_stream().cuda_stream)]
    assert int(ws.abs().sum()) == 0


def test_stream_handle_is_the_current_streams(card):
    # every wrapper launches on native.stream_of, which reads torch's private
    # raw-stream accessor: a torch that drops or changes it fails here
    t = torch.zeros(1, device=card)
    assert native.stream_of(t) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert native.stream_of(t) == side.cuda_stream
    assert native.stream_of(t) == torch.cuda.current_stream().cuda_stream


WKV_TOL = dict(rtol=1e-4, atol=1e-4)
# test_kernels.py::TestWkv6's shapes, the hand check's, the reduced
# model's and the serve head at a short sequence; then head sizes that cut
# through the kernel's 16 x 4 register tiles (K != V, sizes that are not
# multiples of 4 or 8, whose rows are staged with plain loads), S at the
# edges of its 16-step chunks, and a single head (B H = 1, fewer blocks
# than SMs): (B, S, H, K, V)
WKV_SHAPES = [(1, 5, 1, 4, 4), (2, 19, 3, 8, 8), (1, 33, 2, 16, 16),
              (1, 1, 1, 3, 2), (2, 40, 8, 32, 32), (8, 64, 64, 64, 64),
              (1, 17, 2, 5, 7), (2, 33, 3, 33, 17), (1, 40, 2, 63, 64),
              (1, 40, 2, 64, 1), (1, 15, 2, 64, 64), (1, 16, 2, 64, 64),
              (1, 17, 2, 64, 64), (1, 50, 1, 64, 64)]


def _wkv_inputs(shape, dtype, card, seed, w_min=0.5):
    B, S, H, K, V = shape
    gen = torch.Generator(device=card).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=card)
    r, k, v = randn(B, S, H, K), randn(B, S, H, K), randn(B, S, H, V)
    w = torch.sigmoid(randn(B, S, H, K)) * (1 - w_min) + w_min
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, randn(H, K),
            randn(B, H, K, V))


def _wkv6_float64(r, k, v, w, u, s0):
    """The recurrence of ``ref.wkv6_ref`` in float64."""
    r, k, v, w, u, s = (x.double() for x in (r, k, v, w, u, s0))
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("with_s0", [True, False])
def test_wkv6_kernel_matches_plain_version(card, dtype, shape, with_s0):
    r, k, v, w, u, s0 = _wkv_inputs(shape, dtype, card, sum(shape))
    s0 = s0 if with_s0 else None
    before = wkv6.launches
    out, s_final = ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    want_o, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    assert out.dtype == s_final.dtype == torch.float32
    torch.testing.assert_close(out, want_o, **WKV_TOL)
    torch.testing.assert_close(s_final, want_s, **WKV_TOL)
    assert torch.equal(ops.wkv6(r, k, v, w, u, s0)[0], out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wkv6_long_state_matches_float64(card, dtype):
    """2048 steps of one head from a state with w in [0.99, 1): the state
    remembers ~100 steps and outputs reach hundreds, so two float32 orders
    of the sums (the kernel's and the plain version's) can differ by more
    than 1e-4 absolute where an output is near 0. The kernel is held to
    the float64 recurrence within 1e-4 relative plus 1e-5 of the RMS
    absolute, and to no more than twice the float32 plain version's
    distance from it."""
    args = _wkv_inputs((1, 2048, 1, 64, 64), dtype, card, 11, w_min=0.99)
    out, s_final = ops.wkv6(*args)
    assert torch.equal(ops.wkv6(*args)[0], out)
    want_o, want_s = _wkv6_float64(*args)
    plain_o, plain_s = ref.wkv6_ref(*args)
    for got, plain, want in ((out, plain_o, want_o),
                             (s_final, plain_s, want_s)):
        rms = float(want.square().mean().sqrt())
        torch.testing.assert_close(got.double(), want, rtol=1e-4,
                                   atol=1e-5 * rms)
        err = float((got.double() - want).abs().max())
        assert err <= 2 * float((plain.double() - want).abs().max()) + 1e-6


def test_wkv6_steps_and_chunks_equal_one_call(card):
    r, k, v, w, u, s0 = _wkv_inputs((2, 23, 4, 64, 64), torch.bfloat16,
                                    card, 3)
    whole, whole_s = ops.wkv6(r, k, v, w, u, s0)
    s, outs = s0, []
    for t in range(r.shape[1]):         # decode: one launch per token
        o, s = ops.wkv6(*(x[:, t:t + 1].contiguous() for x in (r, k, v, w)),
                        u, s)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, dim=1), whole, **WKV_TOL)
    torch.testing.assert_close(s, whole_s, **WKV_TOL)
    parts, parts_s = ops.wkv6(r, k, v, w, u, s0, seq_chunk=7)
    torch.testing.assert_close(parts, whole, **WKV_TOL)
    torch.testing.assert_close(parts_s, whole_s, **WKV_TOL)


def test_recurrent_wrappers_refuse_bad_input(card):
    a = torch.zeros(1, 4, 8, device=card)
    with pytest.raises(TypeError, match="float32"):
        decay_scan.decay_scan_cuda(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        decay_scan.decay_scan_cuda(a, a.cpu())
    r = torch.zeros(1, 4, 2, 80, device=card)
    with pytest.raises(ValueError, match="at most|\\[1, 64\\]"):
        wkv6.wkv6_cuda(r, r, r, r, torch.zeros(2, 80, device=card))
    r = torch.zeros(1, 4, 2, 8, device=card)
    with pytest.raises(TypeError, match="float32"):
        wkv6.wkv6_cuda(r, r, r, r.bfloat16(), torch.zeros(2, 8, device=card))


# -- the workload families and the journal on the card ------------------------
# SAT instances 0, 1 and 3 of this family are a certificate, a refutation
# and a certificate; 2**12 assignments and 64 x 64 docking pairs a block
_CARD_SUITE = {"sat": {"n_vars": 12, "n_clauses": 50},
               "docking": {"n_r": 64, "n_p": 64}}
_CARD_SCHEDULE = ("sat", "sat", "docking", "sat", "docking", None)


def _journaled_node(device):
    from repro_torch.chain import ChainStore, Node
    node = Node(classic_arg_bits=12, device=device, store=ChainStore(),
                workloads=_card_suite(device))
    for family in _CARD_SCHEDULE:
        node.mine_block(family)
    return node


def _card_suite(device):
    from repro_torch.chain.workloads import default_suite
    return default_suite(seed=5, device=device,
                         **{k: dict(v) for k, v in _CARD_SUITE.items()})


@pytest.fixture(scope="module")
def journaled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = (sha256.launches, merkle.launches)
    card_node = _journaled_node("cuda")
    launched = (sha256.launches - before[0], merkle.launches - before[1])
    return {"cuda": card_node, "cpu": _journaled_node("cpu"),
            "launched": launched}


def test_sat_and_docking_blocks_on_the_card_equal_the_cpus(journaled):
    from repro_torch.chain import store
    card_node, cpu_node = journaled["cuda"], journaled["cpu"]
    payloads = card_node.chain_payloads()
    assert [p.certificate is not None for p in payloads
            if p.workload == "sat"] == [True, False, True]
    for p, q in zip(payloads, cpu_node.chain_payloads()):
        assert store.encode_payload(p) == store.encode_payload(q)
    assert card_node.store.to_bytes() == cpu_node.store.to_bytes()
    assert card_node.ledger.tip_hash == cpu_node.ledger.tip_hash
    # one SHA-256 launch (one chunk) and one reduction a full-mode block,
    # and Classic's two hashes, mined and replayed
    assert journaled["launched"] == (5 + 4, 5)


@pytest.mark.parametrize("writer,reader", [("cuda", "cpu"), ("cpu", "cuda")])
def test_a_journal_recovers_on_the_other_device(journaled, writer, reader):
    from repro_torch.chain import ChainStore, Node
    donor = journaled[writer]
    node = Node.recover(ChainStore.from_bytes(donor.store.to_bytes()),
                        device=reader, classic_arg_bits=12,
                        workloads=_card_suite(reader))
    n = len(_CARD_SCHEDULE)
    rep = node.last_recovery
    assert (rep.replayed, rep.adopted_height, rep.truncated_records,
            rep.resynced_height) == (n, n, 0, n)
    assert node.ledger.tip_hash == donor.ledger.tip_hash
    assert node.book.balances == donor.book.balances
    assert node.audit_chain()


# -- the training slice: the flash backward and the training step -------------
# (B, S, T, H, Kv, causal, window) at each head dim the backward takes.
# After the first seven, its tiles' edges (csrc/flash_attention_bwd.cu:
# both passes 64 queries x 64 keys at hd 64 and 128, 32 x 16 at hd 32):
# S and T of 1, a tile's size +- 1 and 2 BK + 1, S != T both ways without
# the causal mask, windows across a tile's edge (and rows that see no
# key), G = 1, 2 and 16 (MQA).
# T = 1 only with S = 1: with one key, P = 1 and o = v, so the exact dQ
# and dK are 0 and both the kernel and the twin return float32 rounding
# of dO.v - dO.o, summed over S rows (at S = 257, hd 128, ~1e-5 apart)
_BWD_CASES = [(2, 33, 33, 4, 2, True, 0), (1, 100, 100, 8, 1, True, 0),
              (2, 70, 150, 4, 2, False, 0), (1, 150, 70, 4, 4, True, 0),
              (2, 90, 90, 4, 4, True, 17), (4, 32, 32, 8, 4, True, 0),
              (1, 64, 64, 2, 1, True, 32),
              (1, 1, 1, 2, 1, True, 0), (2, 1, 129, 4, 2, False, 0),
              (1, 15, 15, 2, 2, True, 0), (1, 31, 31, 4, 2, True, 0),
              (1, 65, 65, 4, 1, True, 0), (1, 127, 127, 4, 2, True, 0),
              (1, 129, 129, 4, 4, True, 0), (2, 129, 65, 4, 2, False, 0),
              (1, 63, 129, 4, 2, False, 0), (1, 33, 17, 2, 1, False, 0),
              (1, 257, 2, 2, 1, False, 0), (1, 200, 200, 2, 1, True, 70),
              (1, 100, 40, 2, 1, True, 20), (1, 129, 129, 16, 1, True, 0),
              (1, 65, 129, 16, 1, False, 33)]
# |kernel - twin| <= BWD_TOL (1 + |twin|), float32
BWD_TOL = 1e-5


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("case", _BWD_CASES)
def test_flash_backward_kernel_matches_its_twin(card, hd, case):
    from repro_torch.kernels import flash_attention_bwd
    B, S, T, H, Kv, causal, window = case
    gen = torch.Generator(device=card).manual_seed(hd + S + T + H)
    q, k, v = (torch.randn(shape, generator=gen, device=card) for shape in
               ((B, S, H, hd), (B, T, Kv, hd), (B, T, Kv, hd)))
    o, lse = flash_attention.flash_attention_lse_cuda(q, k, v, causal=causal,
                                                      window=window)
    # every row, those that see no key too (-1e30 in both)
    assert torch.allclose(lse, ref.flash_attention_lse_ref(
        q, k, v, causal=causal, window=window), rtol=1e-5, atol=1e-5)
    do = torch.randn(o.shape, generator=gen, device=card)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    again = flash_attention_bwd.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    assert flash_attention_bwd.launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert torch.allclose(g, w, rtol=BWD_TOL, atol=BWD_TOL)


@pytest.mark.parametrize("cap_tiles", [1, 3])
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("case", [(2, 200, 200, 4, 2, True, 0),
                                  (1, 150, 260, 4, 1, False, 0),
                                  (1, 300, 300, 2, 1, True, 70)])
def test_flash_backward_in_chunks_of_key_tiles(card, monkeypatch, case, hd,
                                               cap_tiles):
    """dS tiles capped at about ``cap_tiles`` tiles of (batch row, head):
    the key tiles go in chunks (1 tile: one key tile a chunk), dQ summed
    chunk by chunk; within BWD_TOL of the twin and bit-equal twice."""
    from repro_torch.kernels import flash_attention_bwd
    B, S, T, H, Kv, causal, window = case
    tile = flash_attention_bwd.tile(hd)["dkv_kernel"]
    monkeypatch.setattr(flash_attention_bwd, "DS_CAP_BYTES",
                        cap_tiles * B * H * tile["block_keys"]
                        * tile["block_rows"] * 4)
    gen = torch.Generator(device=card).manual_seed(hd + S + cap_tiles)
    q, k, v = (torch.randn(shape, generator=gen, device=card) for shape in
               ((B, S, H, hd), (B, T, Kv, hd), (B, T, Kv, hd)))
    o, lse = flash_attention.flash_attention_lse_cuda(q, k, v, causal=causal,
                                                      window=window)
    do = torch.randn(o.shape, generator=gen, device=card)
    got = flash_attention_bwd.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    again = flash_attention_bwd.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert torch.allclose(g, w, rtol=BWD_TOL, atol=BWD_TOL)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_lse_instance_equals_the_serving_instance(card, hd):
    gen = torch.Generator(device=card).manual_seed(hd)
    q, k, v = (torch.randn(shape, generator=gen, device=card) for shape in
               ((2, 77, 4, hd), (2, 77, 2, hd), (2, 77, 2, hd)))
    for causal, window in ((True, 0), (False, 0), (True, 9)):
        out, lse = flash_attention.flash_attention_lse_cuda(
            q, k, v, causal=causal, window=window)
        assert torch.equal(out, flash_attention.flash_attention_cuda_core(
            q, k, v, causal=causal, window=window))
        assert torch.allclose(lse, ref.flash_attention_lse_ref(
            q, k, v, causal=causal, window=window), rtol=1e-5, atol=1e-5)


def test_flash_backward_raises_for_what_it_cannot_take(card):
    from repro_torch.kernels import flash_attention_bwd, flash_attention_tc_bwd
    q = torch.randn(1, 8, 2, 32, device=card)
    o, lse = flash_attention.flash_attention_lse_cuda(q, q, q, causal=True)
    with pytest.raises(TypeError, match="float32 only"):
        flash_attention_bwd.flash_attention_bwd_cuda(
            q.bfloat16(), q.bfloat16(), q.bfloat16(), o, lse, o,
            causal=True)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_tc_bwd.flash_attention_tc_bwd_cuda(
            q, q, q, o, lse, o, causal=True)
    # no training instance: float32 at hd 256, bf16 at hd 80 and 32 (bf16
    # at hd 256 trains: the tensor-core training instance and the mma.sync
    # backward)
    x = torch.randn(1, 8, 2, 256, device=card, requires_grad=True)
    with pytest.raises(TypeError, match="ROADMAP"):
        ops.flash_attention(x, x, x, causal=True)
    for hd in (80, 32):
        y = torch.randn(1, 8, 2, hd, device=card).bfloat16()
        with pytest.raises(TypeError, match="ROADMAP"):
            ops.flash_attention(y.requires_grad_(True), y, y, causal=True)


# the bf16 tensor-core backward's cases: (B, S, T, H, Kv, causal, window);
# the last three: S and T off its 128-row items with GQA 8, both off them
# with a window, and more items (480) than the persistent grid has blocks
_TC_BWD_CASES = [(2, 33, 33, 4, 4, True, 0), (1, 100, 100, 8, 4, True, 0),
                 (2, 70, 150, 8, 1, False, 0), (1, 150, 70, 4, 2, True, 0),
                 (2, 90, 90, 4, 4, True, 17), (1, 129, 129, 16, 2, True, 0),
                 (1, 100, 40, 2, 1, True, 20), (3, 1, 1, 2, 1, True, 0),
                 (2, 192, 320, 16, 2, False, 0), (1, 130, 250, 4, 1, True, 45),
                 (16, 300, 300, 8, 2, True, 0)]
# |kernel - twin as bf16| <= TC_BWD_TOL max(1, max |twin|): the kernel
# rounds P and dS to bf16 for its products and its results to bf16
TC_BWD_TOL = 2e-2


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("case", _TC_BWD_CASES)
def test_flash_tc_backward_kernel_matches_its_twin(card, hd, case):
    from repro_torch.kernels import flash_attention_tc, flash_attention_tc_bwd
    B, S, T, H, Kv, causal, window = case
    gen = torch.Generator(device=card).manual_seed(hd + S + T + H)
    q, k, v = (torch.randn(shape, generator=gen, device=card).bfloat16()
               for shape in ((B, S, H, hd), (B, T, Kv, hd), (B, T, Kv, hd)))
    o, lse = flash_attention_tc.flash_attention_tc_lse_cuda(
        q, k, v, causal=causal, window=window)
    assert torch.equal(o, flash_attention_tc.flash_attention_tc_cuda(
        q, k, v, causal=causal, window=window))
    assert torch.allclose(lse, ref.flash_attention_lse_ref(
        q, k, v, causal=causal, window=window), rtol=1e-4, atol=1e-4)
    do = torch.randn(o.shape, generator=gen, device=card).bfloat16()
    before = flash_attention_tc_bwd.launches
    got = flash_attention_tc_bwd.flash_attention_tc_bwd_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    again = flash_attention_tc_bwd.flash_attention_tc_bwd_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    assert flash_attention_tc_bwd.launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, a)
        scale = max(1.0, float(w.abs().max()))
        assert float((g.float() - w.bfloat16().float()).abs().max()) <= \
            TC_BWD_TOL * scale


def _tc_bwd_inputs(card, seed, B, S, H, Kv, hd=128):
    from repro_torch.kernels import flash_attention_tc
    gen = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=card).bfloat16()
               for shape in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))
    o, lse = flash_attention_tc.flash_attention_tc_lse_cuda(q, k, v,
                                                            causal=True)
    do = torch.randn(o.shape, generator=gen, device=card).bfloat16()
    return q, k, v, o, lse, do


# what a call may allocate past dQ, dK, dV and its D and log-sum-exp
# workspaces: the allocator's rounding and the item list (made once a shape)
TC_BWD_MEMORY_MARGIN = 1 << 20


def test_flash_tc_backward_takes_no_s_by_s_workspace(card):
    """At S = T = 1024 a bf16 dS of every (query, key) pair would take 64
    MiB: the call's peak device memory over its inputs stays within its
    outputs and its (B, H, S) workspaces plus a margin."""
    from repro_torch.kernels import flash_attention_tc_bwd
    B, S, H, Kv = 2, 1024, 16, 8
    args = _tc_bwd_inputs(card, 6, B, S, H, Kv)
    flash_attention_tc_bwd.flash_attention_tc_bwd_cuda(*args, causal=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = flash_attention_tc_bwd.flash_attention_tc_bwd_cuda(*args,
                                                             causal=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    outputs = sum(t.numel() * t.element_size() for t in got)
    rows = flash_attention_tc_bwd.tile(128)["item_rows"]
    workspaces = 2 * B * H * (-(-S // rows) * rows) * 4
    assert peak <= outputs + workspaces + TC_BWD_MEMORY_MARGIN
    # such a dS alone would be past that limit
    assert B * H * S * S * 2 > outputs + workspaces + TC_BWD_MEMORY_MARGIN


def test_flash_tc_backward_wrapping_its_grid_equals_rows_one_at_a_time(card):
    """24 batch rows make 720 items, more than the persistent grid has
    blocks, so each block's loop wraps; each row run alone (30 items)
    gives the same bits."""
    from repro_torch.kernels import flash_attention_tc_bwd
    B, S, H, Kv = 24, 300, 8, 2
    args = _tc_bwd_inputs(card, 7, B, S, H, Kv)
    rows = flash_attention_tc_bwd.tile(128)["item_rows"]
    n_items = flash_attention_tc_bwd.schedule(B, S, S, H, Kv, True, 0,
                                              rows).shape[0]
    assert n_items > 2 * torch.cuda.get_device_properties(
        card).multi_processor_count
    whole = flash_attention_tc_bwd.flash_attention_tc_bwd_cuda(*args,
                                                               causal=True)
    for b in range(B):
        one = flash_attention_tc_bwd.flash_attention_tc_bwd_cuda(
            *(t[b:b + 1].contiguous() for t in args), causal=True)
        assert all(torch.equal(w[b:b + 1], o) for w, o in zip(whole, one))


def test_ops_flash_attention_carries_bf16_gradient_through_tc_kernels(card):
    from repro_torch.kernels import flash_attention_tc, flash_attention_tc_bwd
    gen = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn(shape, generator=gen, device=card).bfloat16()
               .requires_grad_(True) for shape in
               ((2, 64, 16, 128), (2, 64, 8, 128), (2, 64, 8, 128)))
    before = (flash_attention_tc.lse_launches, flash_attention_tc_bwd.launches,
              flash_attention.launches)
    out = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    assert (flash_attention_tc.lse_launches - before[0],
            flash_attention_tc_bwd.launches - before[1],
            flash_attention.launches - before[2]) == (1, 1, 0)
    cpu = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*cpu, causal=True).float().square().sum(),
        cpu)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        scale = max(1.0, float(w.abs().max()))
        assert float((g.cpu().float() - w.float()).abs().max()) <= \
            TC_BWD_TOL * scale


def test_two_fresh_qwen3_cut_trainers_agree_bit_for_bit(card):
    """qwen3-0.6b cut to 2 layers at full width, bf16, 4 full-mode blocks
    on two fresh trainers: the same losses, digests and hashes (cuBLAS's
    bf16 products and the hand kernels repeat bit for bit)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.pow_train import PoUWTrainer
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2)
    trainers = [PoUWTrainer(cfg, InputShape("cut", 64, 2, "train"),
                            device="cuda") for _ in range(2)]
    recs = [t.run(4) for t in trainers]
    assert [(r.loss, r.state_digest, r.block_hash) for r in recs[0]] == \
        [(r.loss, r.state_digest, r.block_hash) for r in recs[1]]
    assert trainers[0].state.params["embed"].dtype == torch.bfloat16


def test_ops_flash_attention_carries_the_gradient_through_the_kernels(card):
    from repro_torch.kernels import flash_attention_bwd
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen, device=card)
               .requires_grad_(True) for shape in
               ((4, 32, 8, 32), (4, 32, 4, 32), (4, 32, 4, 32)))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert (flash_attention.launches - before[0],
            flash_attention_bwd.launches - before[1]) == (1, 1)
    cpu = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*cpu, causal=True).square().sum(), cpu)
    for g, w in zip(grads, want):
        assert torch.allclose(g.cpu(), w, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=True)
    assert flash_attention_bwd.launches - before[1] == 1


def test_every_pnpcoin_demo_leaf_gets_its_gradient_on_the_card(card):
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.train import steps
    cfg = get_config("pnpcoin-demo")
    batch = SyntheticTokenPipeline(
        cfg, InputShape("chain32x4", 32, 4, "train")).microbatch(0, 0)
    params = steps.make_train_state(cfg, random.key(0), "cpu").params
    grads = {}
    for dev in ("cpu", card):
        leaves = {p: t.to(dev).requires_grad_(True) for p, t in
                  steps._flatten_with_path(params)}
        tree = steps._unflatten(params, iter(leaves[p] for p in
                                             sorted(leaves)))
        loss, _ = build_model(cfg).loss(tree, batch)
        grads[str(dev)] = dict(zip(sorted(leaves), torch.autograd.grad(
            loss, [leaves[p] for p in sorted(leaves)])))
    for path, g in grads["cuda"].items():
        want = grads["cpu"][path]
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), path
        scale = float(want.abs().max())
        assert float((g.cpu() - want).abs().max()) <= 1e-4 * scale, path


def test_two_fresh_workloads_on_the_card_agree_bit_for_bit(card):
    from repro_torch.chain import BlockContext, store
    from repro_torch.chain.workloads import ModelTrainingWorkload
    a, b, c = (ModelTrainingWorkload(device="cuda", n_miners=2)
               for _ in range(3))
    mined = []
    for height in range(4):
        ctx = BlockContext(height=height, prev_hash="", node_id=0)
        pa, pb = a.mine(a.prepare(ctx)), b.mine(b.prepare(ctx))
        assert (pa.merkle_root, pa.state_digest, pa.loss) == \
            (pb.merkle_root, pb.state_digest, pb.loss)
        mined.append(pa)
    assert a.state_digest() == b.state_digest()
    # a third replays the blocks through the journal's encoding
    assert all(c.verify(store.decode_payload(store.encode_payload(p)))
               for p in mined)
    assert c.state_digest() == a.state_digest()


def test_a_training_step_runs_the_hand_attention_kernels_only(card):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.train import steps
    cfg = get_config("pnpcoin-demo")
    step = steps.make_train_step(cfg)
    state = steps.make_train_state(cfg, random.key(0), "cuda")
    batch = SyntheticTokenPipeline(
        cfg, InputShape("chain32x4", 32, 4, "train")).microbatch(0, 0)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_QUIET_S)
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        time.sleep(PROFILER_QUIET_S)
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    for kernel in ("flash_fwd_kernel", "dq_kernel", "dkv_kernel"):
        assert sum(kernel in n for n in names) == cfg.n_layers, names
    assert not [n for n in names if any(
        lib in n for lib in ("pytorch_flash", "fmha", "efficient_attention",
                             "mem_eff"))]


# -- ES search, PoUWTrainer and GAN inversion on the card ---------------------
# |card - CPU| of ES candidates: their noise differs only where the two
# devices' log1p round differently (relative 2e-6 at most, as against JAX's
# normal); of ES losses, relative: the card scores through the flash kernel
ES_NOISE_TOL, ES_LOSS_TOL = 2e-6, 1e-5


def _es_case():
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.train import steps
    cfg = get_config("pnpcoin-demo")
    batch = SyntheticTokenPipeline(
        cfg, InputShape("es32x2", 32, 2, "train")).batch(0)
    params = steps.make_train_state(cfg, random.key(0), "cpu").params
    return cfg, batch, params


def test_es_candidates_and_losses_on_the_card_equal_the_cpus(card):
    from repro_torch import random
    from repro_torch.core import es
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import steps
    cfg, batch, params = _es_case()
    on_card = tree_map(lambda t: t.to(card), params)
    key, sigma = random.key(7), 0.02
    for i in range(5):
        got = tree_leaves(es.candidate_params(on_card, key, i, sigma))
        want = tree_leaves(es.candidate_params(params, key, i, sigma))
        for g, w in zip(got, want):
            assert g.is_cuda and g.dtype == w.dtype
            tol = sigma * ES_NOISE_TOL + float(
                torch.finfo(torch.float32).eps * w.abs().max())
            assert float((g.cpu() - w).abs().max()) <= tol
    eval_step = steps.make_eval_step(cfg)
    before = flash_attention.launches
    got, gbest = es.es_block(eval_step, on_card, batch, key, pop_size=6,
                             sigma=sigma)
    # one serving launch a layer and candidate
    assert flash_attention.launches - before == 6 * cfg.n_layers
    want, wbest = es.es_block(eval_step, params, batch, key, pop_size=6,
                              sigma=sigma)
    assert torch.allclose(got.cpu(), want, rtol=ES_LOSS_TOL, atol=0)
    assert int(gbest) == int(wbest)


def test_two_fresh_optimal_trainers_on_the_card_agree_bit_for_bit(card):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.pow_train import PoUWTrainer
    trainers = [PoUWTrainer(get_config("pnpcoin-demo"),
                            InputShape("es32x2", 32, 2, "train"),
                            mode="optimal", pop_size=4, sigma=0.02,
                            device="cuda") for _ in range(2)]
    recs = [t.run(2) for t in trainers]
    assert [(r.loss, r.state_digest, r.block_hash) for r in recs[0]] == \
        [(r.loss, r.state_digest, r.block_hash) for r in recs[1]]
    assert trainers[0].audit_block(1)


def test_a_gan_round_on_the_card_finds_the_cpus_winner(card):
    from repro_torch.chain.workloads import GanInversionWorkload
    from repro_torch.core.executor import run_optimal
    wls = {dev: GanInversionWorkload(seed=0, grid_bits=10, device=dev)
           for dev in ("cpu", "cuda")}
    args = torch.arange(1 << 10)
    # the grid's draws are made on the card, as the generator's products
    assert wls["cuda"]._draws(args.to("cuda")).is_cuda
    assert wls["cuda"]._w1.is_cuda
    res = {dev: wl._round_jash().fn(args.to(dev)).cpu()
           for dev, wl in wls.items()}
    # err * 1e4 truncated: each device draws its own latents (their log1p
    # may round apart) and sums in its own order, so results may differ
    # by one
    assert int((res["cuda"] - res["cpu"]).abs().max()) <= 1
    opt = {dev: run_optimal(wl._round_jash(), device=dev)
           for dev, wl in wls.items()}
    assert opt["cuda"].best_arg == opt["cpu"].best_arg


def test_head_dim_80_runs_on_the_tensor_cores_and_trains_nowhere(card):
    assert flash_attention.kernel_for(torch.bfloat16, 80) == "tensor_core"
    q, k, v = _qkv(80, 2, 200, 200, torch.bfloat16, card, 80)
    before, core = flash_attention_tc.launches, flash_attention.launches
    ops.flash_attention(q, k, v, causal=True)
    assert (flash_attention_tc.launches, flash_attention.launches) == \
        (before + 1, core)
    with pytest.raises(TypeError, match="no training instance"):
        flash_attention.train_kernels_for(torch.bfloat16, 80)
    with pytest.raises(TypeError, match="ROADMAP"):
        ops.flash_attention(q.requires_grad_(True), k, v, causal=True)
    # the CUDA-core kernel does not take it: no fallback
    with pytest.raises(ValueError, match="head_dim 80"):
        flash_attention.flash_attention_cuda_core(q.detach(), k, v,
                                                  causal=True)


def test_reduced_moe_expert_choices_on_the_card_equal_the_cpus(card):
    """The reduced olmoe-1b-7b served on the card and on the CPU from the
    same weights by chip_smoke.py's ``reduced_vs_cpu``: every router call
    chooses the same experts (the router's product in float32, TF32 off),
    and the tokens and logits agree."""
    assert not torch.backends.cuda.matmul.allow_tf32
    smoke = runpy.run_path(str(Path(__file__).parents[1] / "chip_smoke.py"))
    out = smoke["reduced_vs_cpu"](card, "olmoe-1b-7b",
                                  {"flash_attention": 2})
    assert out["reduced_router_calls_with_equal_choices"] == 2 * 8


# --------------------------------------------------------------------------
# the recurrent families' training kernels: the decay scan's and WKV-6's
# backward, and bf16 attention's at head dim 256
# --------------------------------------------------------------------------

# (B, S, C, h0, dh_last): S = 1, at and past the kernel's 16 steps of
# loads, odd C, and recurrentgemma-2b's RG-LRU at batch 16
_DECAY_BWD_CASES = [(2, 1, 5, True, True), (2, 16, 33, False, True),
                    (3, 17, 130, True, False), (1, 50, 7, False, False),
                    (16, 256, 2560, False, False)]


@pytest.mark.parametrize("case", _DECAY_BWD_CASES)
def test_decay_scan_bwd_kernel_matches_its_twin(card, case):
    B, S, C, with_h0, with_last = case
    gen = torch.Generator(device=card).manual_seed(B + S + C)
    a = torch.rand((B, S, C), generator=gen, device=card) * 0.7 + 0.3
    b = torch.randn((B, S, C), generator=gen, device=card)
    h0 = torch.randn((B, C), generator=gen, device=card) if with_h0 else None
    h, _ = decay_scan.decay_scan_cuda(a, b, h0)
    dh = torch.randn((B, S, C), generator=gen, device=card)
    dl = torch.randn((B, C), generator=gen, device=card) if with_last \
        else None
    before = decay_scan.bwd_launches
    got = decay_scan.decay_scan_bwd_cuda(a, h, dh, dl, h0)
    again = decay_scan.decay_scan_bwd_cuda(a, h, dh, dl, h0)
    assert decay_scan.bwd_launches == before + 2
    want = ref.decay_scan_bwd_ref(a, h, dh, dl, h0)
    for g, x, w in zip(got, again, want):
        assert torch.equal(g, x)
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


# (B, S, H, K, V): S = 1, at the edges of the backward's 8-step chunks,
# K != V and odd, and rwkv6-7b's heads
_WKV_BWD_SHAPES = [(2, 1, 2, 64, 64), (1, 7, 3, 64, 64), (2, 8, 2, 32, 32),
                   (1, 9, 2, 64, 48), (2, 19, 3, 5, 7), (2, 64, 16, 64, 64)]
# max |kernel - twin in the kernel's dtype| over the twin's largest entry
_WKV_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _WKV_BWD_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_bwd_kernel_matches_its_twin(card, dtype, shape, with_state):
    B, S, H, K, V = shape
    gen = torch.Generator(device=card).manual_seed(sum(shape))

    def randn(*s):
        return torch.randn(s, generator=gen, device=card)
    r, k, v = (randn(B, S, H, d).to(dtype) for d in (K, K, V))
    w = torch.sigmoid(randn(B, S, H, K)) * 0.5 + 0.5
    u, do = randn(H, K), randn(B, S, H, V)
    s0 = randn(B, H, K, V) if with_state else None
    dsf = randn(B, H, K, V) if with_state else None
    before = wkv6.bwd_launches
    got = wkv6.wkv6_bwd_cuda(r, k, v, w, u, do, dsf, s0)
    again = wkv6.wkv6_bwd_cuda(r, k, v, w, u, do, dsf, s0)
    assert wkv6.bwd_launches == before + 2
    want = ref.wkv6_bwd_ref(r, k, v, w, u, do, dsf, s0)
    for name, g, x, wnt in zip("rkvwu", got, again, want):
        assert torch.equal(g, x), name
        assert g.dtype == (dtype if name in "rkv" else torch.float32), name
        wnt = wnt.to(g.dtype).float()
        assert float((g.float() - wnt).abs().max()) <= \
            _WKV_BWD_TOL[dtype] * float(wnt.abs().max()), name


def test_the_recurrences_carry_the_gradient_through_the_kernels(card):
    """With grad on, ops.decay_scan and ops.wkv6 on the card run the
    forward kernel and one call of the backward kernel, and give the CPU
    path's gradients; a start state that requires grad raises."""
    gen = torch.Generator(device=card).manual_seed(11)
    a = (torch.rand((2, 30, 12), generator=gen, device=card) * 0.7 + 0.3)
    b = torch.randn((2, 30, 12), generator=gen, device=card)
    leaves = [x.requires_grad_(True) for x in (a, b)]
    before = (decay_scan.launches, decay_scan.bwd_launches)
    h, h_last = ops.decay_scan(*leaves)
    got = torch.autograd.grad(h.square().sum() + h_last.sum(), leaves)
    assert (decay_scan.launches - before[0],
            decay_scan.bwd_launches - before[1]) == (1, 1)
    cpu = [x.detach().cpu().requires_grad_(True) for x in leaves]
    h, h_last = ops.decay_scan(*cpu)
    want = torch.autograd.grad(h.square().sum() + h_last.sum(), cpu)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(
            w.abs().max())
    with pytest.raises(NotImplementedError, match="h0 requires grad"):
        ops.decay_scan(a.detach(), b.detach(),
                       torch.zeros((2, 12), device=card, requires_grad=True))

    B, S, H, K = 2, 21, 3, 16
    xs = [torch.randn((B, S, H, K), generator=gen, device=card)
          for _ in range(3)]
    w = torch.sigmoid(torch.randn((B, S, H, K), generator=gen,
                                  device=card)) * 0.5 + 0.5
    u = torch.randn((H, K), generator=gen, device=card)
    leaves = [x.requires_grad_(True) for x in (*xs, w, u)]
    before = (wkv6.launches, wkv6.bwd_launches)
    out, s_final = ops.wkv6(*leaves)
    got = torch.autograd.grad(out.square().sum() + s_final.sum(), leaves)
    assert (wkv6.launches - before[0], wkv6.bwd_launches - before[1]) == \
        (1, 1)
    cpu = [x.detach().cpu().requires_grad_(True) for x in leaves]
    out, s_final = ops.wkv6(*cpu)
    want = torch.autograd.grad(out.square().sum() + s_final.sum(), cpu)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())
    with pytest.raises(NotImplementedError, match="s0 requires grad"):
        ops.wkv6(*(x.detach() for x in leaves),
                 torch.zeros((B, H, K, K), device=card, requires_grad=True))


# the hd-256 backward's cases: (B, S, T, H, Kv, causal, window):
# recurrentgemma's 10 heads over 1 with windows shorter than S, ragged,
# S != T, one query, GQA 2, not causal
_TC256_BWD_CASES = [(2, 200, 200, 10, 1, True, 64), (1, 130, 130, 2, 2, True, 0),
                    (1, 77, 77, 4, 1, False, 0), (1, 100, 170, 4, 2, False, 0),
                    (3, 1, 1, 10, 1, True, 0), (1, 129, 129, 10, 1, True, 33)]


@pytest.mark.parametrize("case", _TC256_BWD_CASES)
def test_flash_hd256_backward_kernel_matches_its_twin(card, case):
    from repro_torch.kernels import flash_attention_mma_bwd
    B, S, T, H, Kv, causal, window = case
    gen = torch.Generator(device=card).manual_seed(S + T + H + window)
    q, k, v = (torch.randn(shape, generator=gen, device=card).bfloat16()
               for shape in ((B, S, H, 256), (B, T, Kv, 256),
                             (B, T, Kv, 256)))
    o, lse = flash_attention_tc.flash_attention_tc_lse_cuda(
        q, k, v, causal=causal, window=window)
    assert torch.equal(o, flash_attention_tc.flash_attention_tc_cuda(
        q, k, v, causal=causal, window=window))
    assert torch.allclose(lse, ref.flash_attention_lse_ref(
        q, k, v, causal=causal, window=window), rtol=1e-4, atol=1e-4)
    do = torch.randn(o.shape, generator=gen, device=card).bfloat16()
    before = flash_attention_mma_bwd.launches
    got = flash_attention_mma_bwd.flash_attention_mma_bwd_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    again = flash_attention_mma_bwd.flash_attention_mma_bwd_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    assert flash_attention_mma_bwd.launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, a)
        scale = max(1.0, float(w.abs().max()))
        assert float((g.float() - w.bfloat16().float()).abs().max()) <= \
            TC_BWD_TOL * scale


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_reduced_recurrent_models_train_on_the_card_as_on_the_cpu(card,
                                                                   arch):
    """A reduced float32 model of each recurrent family from the same
    threefry init: its loss and every gradient leaf on the card (the decay
    scan's or WKV-6's forward and backward kernels, the CUDA-core flash
    pair at hd 32) against the CPU port's; one step's launches."""
    from repro_torch import random
    from repro_torch.configs.base import InputShape, get_config, reduced
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    batch = SyntheticTokenPipeline(cfg, InputShape("t", 48, 2, "train"),
                                   seed=0).batch(0)
    out = {}
    for device in (card, torch.device("cpu")):
        params = tree_map(lambda t: t.requires_grad_(True),
                          model.init(random.key(0).to(device)))
        before = (decay_scan.bwd_launches, wkv6.bwd_launches)
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out[device.type] = (float(loss), [g.cpu() for g in grads],
                            (decay_scan.bwd_launches - before[0],
                             wkv6.bwd_launches - before[1]))
    want = (2, 0) if arch == "recurrentgemma-2b" else (0, 2)
    assert out["cuda"][2] == want and out["cpu"][2] == (0, 0)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        assert float(torch.linalg.vector_norm(g - w)) <= 1e-4 * float(
            torch.linalg.vector_norm(w))
