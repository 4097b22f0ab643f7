"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a card. Without one every test here skips.

This file imports no JAX, so it also runs on a machine that has only the
port's dependencies::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (flash_attention, merkle, ops,  # noqa: E402
                                 ref, sha256)

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("B,w", [(1, 1), (1, 2), (1, 65), (1, 4097),
                                 (3, 300)])
def test_merkle_kernel_matches_plain_version(card, B, w):
    rows = _words((8, B, w), B * w)
    before = merkle.launches
    got = merkle.merkle_level(rows.to(card))
    torch.cuda.synchronize()
    assert merkle.launches == before + 1
    assert torch.equal(got.cpu(), merkle._node_hash_ref(rows))


def test_wrappers_refuse_bad_input(card):
    with pytest.raises(TypeError, match="int64"):
        sha256.sha256_rows_cuda(torch.zeros((2, 2), dtype=torch.int32,
                                            device=card))
    with pytest.raises(ValueError, match="contiguous"):
        sha256.sha256_rows_cuda(torch.zeros((4, 4), dtype=torch.int64,
                                            device=card)[:, ::2])
    with pytest.raises(ValueError, match=r"\(8, B, w"):
        merkle.merkle_level(torch.zeros((7, 1, 4), dtype=torch.int64,
                                        device=card))


# chip_smoke.py's flash_vs_plain cases: (hd, G, causal, S, T)
FLASH_CASES = [(hd, g, causal, n, n) for hd in (32, 64, 128)
               for g in (1, 2) for causal in (True, False)
               for n in (33, 1000, 2048)]
FLASH_CASES += [(hd, 2, False, 700, 1500) for hd in (32, 64, 128)]
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


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
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # one block owns each row and sums in a fixed order: run to run equal
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal), got)


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
