"""The port's Merkle trees, block headers and ledger against the JAX
package's, bit for bit.

The JAX package's own device tree (``_tree_fn``) is compared only where it
stays on the host (at most ``_CUTOVER`` = 64 leaves): its compile on a CPU
is far too slow for this suite. Above that the port is held against the
reference's hashlib tree (``repro.core.ledger``, ``backend="hashlib"``).
On the CPU the port's wide levels run the plain version of the Merkle
kernel; ``tests/test_torch_cuda.py`` holds the kernel against it on a
card."""
import hashlib
import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ledger as jledger  # noqa: E402
from repro.kernels import merkle as jmerkle  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ledger  # noqa: E402
from repro_torch.kernels import merkle  # noqa: E402

SIZES = [1, 2, 3, 5, 8, 13, 31, 64, 65, 100, 300]
CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" \
    / "kernels" / "csrc"


def _leaves(n, kind, seed=0):
    rng = random.Random(1000 * seed + n)
    if kind == "ragged":
        return [rng.randbytes(rng.randint(1, 40)) for _ in range(n)]
    return [rng.randbytes(36) for _ in range(n)]


def _proof_indices(n):
    return range(n) if n <= 16 else sorted({0, 1, n // 2, n - 2, n - 1})


@pytest.mark.parametrize("kind", ["ragged", "uniform"])
@pytest.mark.parametrize("n", SIZES)
def test_root_levels_and_proofs_match_reference(n, kind):
    leaves = _leaves(n, kind)
    want = jledger.merkle_root(leaves, backend="hashlib")
    assert merkle.merkle_root_device(leaves, device="cpu") == want
    assert ledger.merkle_root(leaves, backend="device", device="cpu") == want
    assert ledger.merkle_root(leaves, backend="hashlib") == want
    levels = merkle.merkle_levels_device(leaves, device="cpu")
    if n <= merkle._CUTOVER:            # reference stays on the host here
        assert jmerkle.merkle_root_device(leaves) == want
        ref_levels = jmerkle.merkle_levels_device(leaves)
        assert len(levels) == len(ref_levels)
        for got, exp in zip(levels, ref_levels):
            np.testing.assert_array_equal(got, exp)
    assert merkle.words_to_hex(levels[-1][0]) == want
    for i in _proof_indices(n):
        proof = merkle.merkle_proof_device(leaves, i, device="cpu")
        assert proof == jledger.merkle_proof(leaves, i)
        assert proof == ledger.merkle_proof(leaves, i)
        assert ledger.verify_merkle_proof(leaves[i], proof, want)


def test_empty_leaf_set():
    empty = hashlib.sha256(b"").hexdigest()
    assert merkle.merkle_root_device([], device="cpu") == empty
    assert ledger.merkle_root([], backend="device", device="cpu") == empty
    assert jledger.merkle_root([], backend="hashlib") == empty
    assert merkle.merkle_roots_from_digests(
        np.zeros((2, 0, 8), np.uint32), device="cpu") == [empty, empty]


@pytest.mark.parametrize("n", [1000, 4097])
def test_large_trees_match_hashlib(n):
    leaves = _leaves(n, "uniform", seed=7)
    assert merkle.merkle_root_device(leaves, device="cpu") == \
        jledger.merkle_root(leaves, backend="hashlib")


def test_forest_matches_single_trees():
    rng = np.random.RandomState(3)
    d = rng.randint(0, 2**32, (3, 201, 8), dtype=np.uint64).astype(np.uint32)
    roots = merkle.merkle_roots_from_digests(d, device="cpu")
    for b in range(3):
        assert roots[b] == merkle.merkle_root_from_digests(d[b], device="cpu")
        leaves_hex = [merkle.words_to_hex(row) for row in d[b]]
        # the digests as given are the leaf level: rebuild with hashlib
        level = [bytes.fromhex(h) for h in leaves_hex]
        while len(level) > 1:
            if len(level) % 2:
                level.append(level[-1])
            level = [hashlib.sha256(level[i] + level[i + 1]).digest()
                     for i in range(0, len(level), 2)]
        assert roots[b] == level[0].hex()


def test_kw_table_matches_reference_and_kernel_source():
    assert merkle._KW == jmerkle._KW
    text = (CSRC / "merkle.cu").read_text()
    table = text[text.index("kKW[64]"):]
    table = table[:table.index("};")]
    got = tuple(int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", table))
    assert got == merkle._KW


def test_odd_level_plain_version_duplicates_last_node():
    rng = np.random.RandomState(5)
    level = torch.from_numpy(
        rng.randint(0, 2**32, (2, 5, 8), dtype=np.uint64).astype(np.int64))
    out = merkle._node_hash_ref(level)
    assert out.shape == (2, 3, 8)
    for b in range(2):
        last = level[b, 4].numpy().astype(">u4").tobytes()
        want = hashlib.sha256(last + last).digest()
        assert merkle.words_to_hex(out[b, 2].numpy()) == want.hex()


def _digests(shape, seed):
    rng = np.random.RandomState(seed)
    d = rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    d.flat[0], d.flat[-1] = 2**32 - 1, 2**31     # words at and above 2**31
    return d


def _hashlib_levels(tree):
    """Every level after the leaves of one tree, by hashlib, down to the
    first at most ``_CUTOVER`` wide, as (w, 8) uint32."""
    level, out = [row.astype(">u4").tobytes() for row in tree], []
    while len(level) > merkle._CUTOVER:
        if len(level) % 2:
            level.append(level[-1])
        level = [hashlib.sha256(level[i] + level[i + 1]).digest()
                 for i in range(0, len(level), 2)]
        out.append(merkle.pack_digests(level))
    return out


@pytest.mark.parametrize("B,w", [(1, 2), (3, 5), (2, 64)])
def test_row_major_level_matches_reference_node_hash(B, w):
    # the reference's words-major _node_hash, run eagerly on the pairs
    # (its device tree compiles too slowly on a CPU above 64 leaves)
    d = _digests((B, w, 8), B * 100 + w)
    got = merkle._node_hash_ref(torch.from_numpy(d.astype(np.int64)))
    padded = np.concatenate([d, d[:, -1:]], axis=1) if w % 2 else d
    pairs = padded.reshape(B, -1, 16)
    want = jmerkle._node_hash([jnp.asarray(pairs[..., i].reshape(-1))
                               for i in range(16)])
    want = np.stack([np.asarray(x) for x in want], -1).reshape(B, -1, 8)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("B,n", [(1, 65), (3, 127), (4, 129), (1, 4097),
                                 (3, 200), (2, 64), (4, 1)])
@pytest.mark.parametrize("keep", [False, True])
def test_plain_reduction_matches_hashlib(B, n, keep):
    # odd widths, forests of 1, 3 and 4 trees, and trees that need no
    # reduction (n <= 64: no level, so nothing would launch on a card)
    d = _digests((B, n, 8), B * 7919 + n)
    got = merkle.merkle_reduce(torch.from_numpy(d.view(np.int32)),
                               keep_levels=keep)
    want = [_hashlib_levels(d[b]) for b in range(B)]
    widths = merkle._widths(n)
    assert [lv.shape for lv in got] == [
        (B, w, 8) for w in (widths if keep else widths[-1:])]
    for b in range(B):
        levels = want[b] if keep else want[b][-1:]
        for lv, exp in zip(got, levels):
            assert lv.dtype == torch.int32
            np.testing.assert_array_equal(lv[b].numpy().view(np.uint32), exp)


@pytest.mark.parametrize("n", [65, 127, 129, 4097])
def test_levels_and_proofs_of_odd_widths_match_hashlib(n):
    leaves = _leaves(n, "uniform", seed=11)
    levels = merkle.merkle_levels_device(leaves, device="cpu")
    assert len(levels[0]) == n + n % 2
    np.testing.assert_array_equal(
        levels[1][:(n + 1) // 2],
        merkle.pack_digests([hashlib.sha256(levels[0][i].astype(">u4")
                                            .tobytes() +
                                            levels[0][i + 1].astype(">u4")
                                            .tobytes()).digest()
                             for i in range(0, n + n % 2, 2)]))
    root = jledger.merkle_root(leaves, backend="hashlib")
    for i in sorted({0, n // 3, n - 2, n - 1}):
        proof = merkle.merkle_proof_device(leaves, i, device="cpu")
        assert proof == jledger.merkle_proof(leaves, i)
        assert ledger.verify_merkle_proof(leaves[i], proof, root)


def test_reduce_refuses_bad_input():
    with pytest.raises(TypeError, match="int32"):
        merkle.merkle_reduce(torch.zeros((1, 70, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(B, n, 8\)"):
        merkle.merkle_reduce(torch.zeros((70, 8), dtype=torch.int32))


def test_packing_helpers_match_reference():
    leaves = _leaves(9, "uniform")
    np.testing.assert_array_equal(merkle.pack_leaves(leaves),
                                  jmerkle.pack_leaves(leaves))
    assert merkle.pack_leaves(_leaves(9, "ragged")) is None
    digests = [hashlib.sha256(x).digest() for x in leaves]
    np.testing.assert_array_equal(merkle.pack_digests(digests),
                                  jmerkle.pack_digests(digests))


@pytest.mark.parametrize("index", [-1, 5, 8])
def test_out_of_range_proof_raises(index):
    leaves = _leaves(5, "ragged")
    with pytest.raises(IndexError, match="out of range"):
        merkle.merkle_proof_device(leaves, index, device="cpu")
    with pytest.raises(IndexError, match="out of range"):
        ledger.merkle_proof(leaves, index)


def test_header_bytes_block_hash_and_genesis_match():
    assert ledger.Ledger.GENESIS_HASH == jledger.Ledger.GENESIS_HASH
    fields = [
        dict(height=0, prev_hash=jledger.Ledger.GENESIS_HASH, jash_id="ab",
             mode="full", merkle_root="cd", winner=None, best_res=None,
             n_results=64),
        dict(height=3, prev_hash="ff" * 32, jash_id="0123456789abcdef",
             mode="optimal", merkle_root="ee" * 32, winner=65537,
             best_res="00ff", n_results=1 << 20, state_digest="x",
             timestamp=12.5),
    ]
    for f in fields:
        a, b = ledger.Block(**f), jledger.Block(**f)
        assert a.header_bytes() == b.header_bytes()
        assert a.block_hash == b.block_hash


def test_ledger_round_trips_through_json():
    ref = jledger.Ledger()
    for i in range(3):
        ref.append(jash_id=f"j{i}", mode="classic", merkle=f"r{i}",
                   winner=i, best_res="ab", n_results=256)
    port = convert.ledger_from_json(ref.to_json())
    assert port.verify_chain()
    assert port.tip_hash == ref.tip_hash
    assert port.to_json() == ref.to_json()

