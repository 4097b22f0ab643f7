"""The port's SHA-256 against hashlib and the JAX package, bit for bit.

On the CPU the port's ``sha256_words`` runs its plain PyTorch version; the
CUDA kernel itself is held against that version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import hashlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.merkle import bswap32 as jbswap32  # noqa: E402
from repro_torch import device as tdevice  # noqa: E402
from repro_torch.kernels import native, ops, ref, sha256  # noqa: E402

SHAPES = [(1, 1), (7, 4), (128, 12), (200, 13), (64, 14), (16, 20), (3, 32)]
CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" \
    / "kernels" / "csrc"


def _msg(n, w):
    """Random words with the top bit set in some of them for sure."""
    msg = np.random.RandomState(n * 31 + w).randint(
        0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    msg[0, 0] = 0xFFFFFFFF
    msg[-1, -1] = 0x80000000
    return msg


def _t(words):
    return torch.from_numpy(np.asarray(words, np.uint32).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("n,w", SHAPES)
def test_sha256_vs_hashlib_and_jax(n, w):
    msg = _msg(n, w)
    got = _np(ops.sha256_words(_t(msg)))
    np.testing.assert_array_equal(got, jref.sha256_words_hashlib(msg))
    np.testing.assert_array_equal(got, ref.sha256_words_hashlib(msg))
    np.testing.assert_array_equal(
        got, np.asarray(jops.sha256_words(jnp.asarray(msg), backend="jnp")))


@pytest.mark.parametrize("n,w", [(7, 4), (16, 20)])
def test_sha256_vs_pallas_interpret(n, w):
    msg = _msg(n, w)
    np.testing.assert_array_equal(
        _np(ops.sha256_words(_t(msg))),
        np.asarray(jops.sha256_words(jnp.asarray(msg), backend="pallas")))


@pytest.mark.parametrize("n,w", [(1, 1), (64, 2), (200, 13), (3, 32)])
def test_sha256_bswap_matches_jax_bswap_then_hash(n, w):
    msg = _msg(n, w)
    want = np.asarray(jops.sha256_words(jbswap32(jnp.asarray(msg))))
    raw, swapped = ops.sha256_digests(_t(msg), raw=True, bswap=True)
    np.testing.assert_array_equal(_np(swapped), want)
    np.testing.assert_array_equal(_np(ops.sha256_words(_t(msg), bswap=True)),
                                  want)
    np.testing.assert_array_equal(_np(raw), jref.sha256_words_hashlib(msg))
    np.testing.assert_array_equal(
        _np(ref.bswap32(_t(msg))), np.asarray(jbswap32(jnp.asarray(msg))))


def test_known_vector_four_zero_bytes():
    want = np.frombuffer(hashlib.sha256(b"\x00" * 4).digest(), ">u4")
    got = ops.sha256_words(torch.zeros((1, 1), dtype=torch.int64))
    np.testing.assert_array_equal(_np(got)[0], want)


def test_cuda_constants_match_the_reference_table():
    text = (CSRC / "sha256_common.cuh").read_text()
    table = text[text.index("kSha256K[64]"):text.index("};")]
    got = [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", table)]
    assert got == [int(k) for k in jref._K] == [int(k) for k in ref._K]
    np.testing.assert_array_equal(ref._H0, jref._H0)


def test_wrapper_refuses_cpu_and_bad_input():
    msg = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        sha256.sha256_rows_cuda(msg)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.sha256_words(msg.to("meta"))
    assert sha256.launches == 0


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve(None)
    assert tdevice.resolve("cpu") == torch.device("cpu")

