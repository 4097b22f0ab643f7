"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a card. Without one every test here skips.

This file imports no JAX, so it also runs on a machine that has only the
port's dependencies::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import merkle, ref, sha256  # noqa: E402

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
