"""The port's jash contract, Runtime Authority, executors and verification
against the JAX package, bit for bit (all of it is integer work)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import authority as jauth  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.core import jash as jjash  # noqa: E402
from repro.core import verify as jverify  # noqa: E402
from repro_torch.core import authority, executor, jash, verify  # noqa: E402
from repro_torch.core.ledger import merkle_root  # noqa: E402
from repro_torch.kernels.native import MASK32  # noqa: E402

CPU = "cpu"
# args below 2**20 whose trajectories climb past 2**32 within 512 steps
# (the reference's uint32 `3 * b + 1` wraps there)
WRAPPING_ARGS = [159487, 212649, 239231, 270271, 288615, 318974, 318975,
                 358847]


def _pair(max_steps=64, arg_bits=6, **meta):
    """The same collatz jash in both packages."""
    jm = jjash.JashMeta(arg_bits=arg_bits, res_bits=32, **meta)
    tm = jash.JashMeta(arg_bits=arg_bits, res_bits=32, **meta)
    jb, tb = jjash.collatz_jash(max_steps), jash.collatz_jash(max_steps)
    return (jjash.Jash(jb.name, jb.fn, jm, example_args=jb.example_args),
            jash.Jash(tb.name, tb.fn, tm, example_args=tb.example_args))


def _jax_collatz(args, max_steps):
    fn = jax.jit(jax.vmap(jjash.collatz_jash(max_steps).fn))
    return np.asarray(fn(jnp.asarray(args, jnp.uint32)))


def _torch_collatz(args, max_steps):
    out = jash.collatz_jash(max_steps).fn(
        torch.as_tensor(np.asarray(args, np.int64)))
    return out.numpy().astype(np.uint32)


# --------------------------------------------------------------------------
# jash meta and ids
# --------------------------------------------------------------------------


@pytest.mark.parametrize("meta", [
    dict(arg_bits=16, res_bits=32),
    dict(arg_bits=6, res_bits=32, importance=0.8, description="Collatz"),
    dict(arg_bits=20, res_bits=256, max_arg=1000, data_checksum="ab",
         data_acquisition="p2p", importance=0.0, description="x ü"),
])
def test_meta_repr_and_source_id_match(meta):
    tm, jm = jash.JashMeta(**meta), jjash.JashMeta(**meta)
    assert repr(tm) == repr(jm)
    assert tm.n_args == jm.n_args
    assert jash.Jash("n", None, tm).source_id() == \
        jjash.Jash("n", None, jm).source_id()


def test_builtin_jash_ids_match():
    assert jash.collatz_jash().source_id() == jjash.collatz_jash().source_id()
    assert authority.classic_jash().source_id() == \
        jauth.classic_jash().source_id()


# --------------------------------------------------------------------------
# jash results
# --------------------------------------------------------------------------


@pytest.mark.parametrize("max_steps", [64, 512])
def test_collatz_matches_jax_over_first_1024_args(max_steps):
    args = np.arange(1024)
    np.testing.assert_array_equal(_torch_collatz(args, max_steps),
                                  _jax_collatz(args, max_steps))


def test_collatz_wraps_like_uint32_past_two_to_the_32():
    got = _torch_collatz(WRAPPING_ARGS, 512)
    np.testing.assert_array_equal(got, _jax_collatz(WRAPPING_ARGS, 512))


def test_collatz_small_values_by_hand():
    # 0 and 1 take 0 steps (0 is clamped to 1); 27 takes 111
    np.testing.assert_array_equal(_torch_collatz([0, 1, 2, 3, 27], 1024),
                                  [0, 0, 1, 7, 111])


def test_classic_matches_jax_over_256_nonces():
    want = np.asarray(jax.vmap(jauth._classic_fn)(
        jnp.arange(256, dtype=jnp.uint32)))
    got = authority._classic_fn(torch.arange(256, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_bounded_while_flags():
    state, done = jash.bounded_while(lambda s: s < 100, lambda s: s + 1,
                                     torch.tensor(0), max_steps=10)
    assert not bool(done) and int(state) == 10
    state, done = jash.bounded_while(lambda s: s < 3, lambda s: s + 1,
                                     torch.tensor(0), max_steps=50)
    assert bool(done) and int(state) == 3


# --------------------------------------------------------------------------
# validation (the accept/reject cases of tests/test_jash.py)
# --------------------------------------------------------------------------


@torch.library.custom_op("repro_torch_test::echo", mutates_args=())
def _echo(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_echo.register_fake
def _(x):
    return torch.empty_like(x)


def _j(fn, name="t"):
    return jash.Jash(name, fn, jash.JashMeta(32, 32),
                     example_args=(torch.tensor([5, 7], dtype=torch.int64),))


def _while(x):
    from torch._higher_order_ops import while_loop
    return while_loop(lambda s: (s < x).all(), lambda s: (s + 1,),
                      (torch.zeros_like(x),))[0]


def _nested_while(x):
    from torch._higher_order_ops import cond
    return cond(x.sum() > 0, _while, lambda y: y + 1, (x,))


def _print_io(x):
    torch.ops.aten._print("hello")
    return x + 1


def _callback(x):
    return _echo(x) + 1


def _long_scan(x):
    from torch._higher_order_ops import scan
    return scan(lambda c, s: (c + s, c.clone()), x,
                torch.ones(4096, dtype=torch.int64))[0]


def _bounded_forms(x):
    from torch._higher_order_ops import cond, scan
    acc = torch.ones_like(x)
    for _ in range(16):
        acc = (acc * 3 + x) & MASK32
    ys = scan(lambda c, s: (c + s, c.clone()), acc,
              torch.ones(8, dtype=torch.int64))[0]
    return cond(x.sum() > 0, lambda a, b: a + b, lambda a, b: a - b,
                (ys, acc))


@pytest.mark.parametrize("fn,match", [
    (_while, "unbounded"),
    (_nested_while, "unbounded"),
    (_print_io, "IO/callback"),
    (_callback, "IO/callback"),
    (_long_scan, "scan length 4096"),
])
def test_validation_rejects(fn, match):
    with pytest.raises(jash.JashValidationError, match=match):
        _j(fn).validate(loop_bound=1024)


def test_validation_accepts_bounded_forms_and_collatz():
    _j(_bounded_forms).validate(loop_bound=1024)
    program = jash.collatz_jash(512).validate()
    scans = [n for n in program.graph.nodes if n.op == "call_function"
             and jash._op_name(n.target) == "scan"]
    assert len(scans) == 1              # the bound is read off one scan
    with pytest.raises(jash.JashValidationError, match="scan length 512"):
        jash.collatz_jash(512).validate(loop_bound=511)


# --------------------------------------------------------------------------
# the Runtime Authority
# --------------------------------------------------------------------------


def test_authority_reviews_queues_and_falls_back_to_classic():
    ra = authority.RuntimeAuthority(device=CPU)
    _, tj = _pair(arg_bits=6, importance=0.8)
    report = ra.submit(tj)
    assert report.compiled and report.loop_bound_ok and not report.vetoed
    assert report.jash_id == tj.source_id() and report.priority > 0
    assert ra.submit(tj, veto=True).vetoed
    assert ra.queue_depth == 1
    published, source = ra.publish_next()
    assert (published is tj, source) == (True, "queued")
    ra.requeue(tj)
    assert ra.publish_next()[1] == "queued"
    published, source = ra.publish_next()
    assert source == "classic" and published.name == "classic-sha256"


# --------------------------------------------------------------------------
# executors
# --------------------------------------------------------------------------


def _assert_full_equal(t, j):
    for f in ("args", "results", "hashes", "miner_of", "leaf_digests"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.merkle_leaves == j.merkle_leaves
    assert t.commit_root() == j.commit_root()


@pytest.mark.parametrize("lanes", [1, 3])
def test_run_full_matches_jax(lanes):
    jj, tj = _pair(arg_bits=6)
    want = jexec.run_full(jj, chunk_size=13, lanes=lanes)
    got = executor.run_full(tj, chunk_size=13, lanes=lanes, device=CPU)
    _assert_full_equal(got, want)
    _assert_full_equal(executor.run_full(tj, lanes=lanes, device=CPU), want)


def _two_word(a):
    h = ((a * 0x9E3779B1) & MASK32) ^ (a >> 3)
    return torch.stack([h % 7, h ^ 0xABCD], dim=1)


def _two_word_jax(a):
    h = (a * jnp.uint32(0x9E3779B1)) ^ (a >> jnp.uint32(3))
    return jnp.stack([h % jnp.uint32(7), h ^ jnp.uint32(0xABCD)])


def _all_maxw(a):
    return torch.stack([a * 0, a * 0 + MASK32], dim=1)


def _all_maxw_jax(a):
    return jnp.stack([a * 0, a * 0 + jnp.uint32(0xFFFFFFFF)])


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("fns", [
    "collatz", (_two_word, _two_word_jax), (_all_maxw, _all_maxw_jax)])
def test_run_optimal_matches_jax(fns, lanes):
    if fns == "collatz":
        jj, tj = _pair(arg_bits=6)
    else:
        meta = dict(arg_bits=9, res_bits=64)
        tj = jash.Jash("w", fns[0], jash.JashMeta(**meta))
        jj = jjash.Jash("w", fns[1], jjash.JashMeta(**meta))
    want = jexec.run_optimal(jj, lanes=lanes)
    got = executor.run_optimal(tj, lanes=lanes, device=CPU)
    assert (got.best_arg, got.winner, got.n_evaluated) == \
        (want.best_arg, want.winner, want.n_evaluated)
    assert got.best_res.dtype == want.best_res.dtype == np.uint32
    np.testing.assert_array_equal(got.best_res, want.best_res)
    if fns != "collatz" and fns[0] is _all_maxw:
        assert got.best_arg == 0       # every row ties at MAXW: first wins


def test_run_full_rejects_bad_arguments():
    _, tj = _pair()
    with pytest.raises(ValueError, match="chunk_size"):
        executor.run_full(tj, chunk_size=0, device=CPU)
    with pytest.raises(ValueError, match="lanes"):
        executor.run_optimal(tj, lanes=0, device=CPU)


# --------------------------------------------------------------------------
# verification
# --------------------------------------------------------------------------


def _tampered(full, cls, at=range(0, 64, 4)):
    res = np.array(full.results)
    for i in at:
        res[i] ^= 1
    return cls(args=full.args, results=res, hashes=full.hashes,
               miner_of=full.miner_of, leaf_digests=full.leaf_digests)


def test_verify_reports_match_jax_for_honest_and_tampered():
    jj, tj = _pair(arg_bits=6)
    jfull = jexec.run_full(jj)
    tfull = executor.run_full(tj, device=CPU)
    for jf, tf in [(jfull, tfull),
                   (_tampered(jfull, jexec.FullResult),
                    _tampered(tfull, executor.FullResult))]:
        want = jverify.quorum_verify(jj, jf, fraction=0.5)
        got = verify.quorum_verify(tj, tf, fraction=0.5, device=CPU)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        (gb,) = verify.quorum_verify_batched([(tj, tf)], fraction=0.5,
                                             device=CPU)
        assert gb == got
    assert not got.ok and set(got.mismatched_args) <= set(range(0, 64, 4))


def test_recompute_roots_and_inclusion():
    _, tj = _pair(arg_bits=7)
    fulls = [executor.run_full(tj, device=CPU)]
    _, other = _pair(max_steps=32, arg_bits=5)
    fulls.append(executor.run_full(other, device=CPU))
    before = verify.hashlib_fallbacks
    roots = verify.recompute_roots_batched(fulls, device=CPU)
    assert roots == [merkle_root(list(f.merkle_leaves), backend="hashlib")
                     for f in fulls] == [f.commit_root() for f in fulls]
    assert verify.hashlib_fallbacks == before
    assert verify.verify_inclusion(fulls[0], 100, roots[0])
    assert not verify.verify_inclusion(fulls[0], 100, roots[1])
    with pytest.raises(IndexError, match="out of range"):
        verify.verify_inclusion(fulls[0], 128, roots[0])


def test_recompute_roots_falls_back_to_hashlib_and_counts(monkeypatch):
    _, tj = _pair(arg_bits=7)
    full = executor.run_full(tj, device=CPU)
    monkeypatch.setattr(verify, "merkle_roots_from_digests",
                        lambda d, device=None: ["00" * 32] * len(d))
    before = verify.hashlib_fallbacks
    assert verify.recompute_roots_batched([full], device=CPU) == \
        [full.commit_root()]
    assert verify.hashlib_fallbacks == before + 1


# --------------------------------------------------------------------------
# the Runtime Authority's FLOP count and queue order
# --------------------------------------------------------------------------

MM = 32          # the matrix jash's (MM, MM) @ (MM, MM) product


def _matrix_pair(importance):
    """The same jash in both packages: a (MM, MM) matrix made from the arg,
    times its transpose, summed to one word."""
    def jfn(arg):
        a = (arg & 255).astype(jnp.float32) + jnp.arange(
            MM * MM, dtype=jnp.float32).reshape(MM, MM)
        return (a @ a.T).sum().astype(jnp.uint32)

    def tfn(args):
        a = (args & 255).float()[:, None, None] + torch.arange(
            MM * MM, dtype=torch.float32).reshape(1, MM, MM)
        out = torch.matmul(a, a.transpose(1, 2)).sum(dim=(1, 2))
        return out.to(torch.int64) & MASK32

    meta = dict(arg_bits=6, res_bits=32, importance=importance)
    return (jjash.Jash("matrix", jfn, jjash.JashMeta(**meta),
                       example_args=(jnp.uint32(3),)),
            jash.Jash("matrix", tfn, jash.JashMeta(**meta),
                      example_args=(torch.tensor([3], dtype=torch.int64),)))


@pytest.mark.parametrize("max_steps", [64, 1024])
def test_flops_estimate_of_collatz_is_within_2x_of_reference(max_steps):
    jj, tj = _pair(max_steps=max_steps)
    want = jauth.RuntimeAuthority(runtime_probe_n=2).submit(jj).flops_estimate
    got = authority.RuntimeAuthority(device=CPU, runtime_probe_n=2).submit(
        tj).flops_estimate
    assert want > 0 and want / 2 <= got <= 2 * want, (got, want)
    # a loop body counts once, at any bound
    assert got == authority.count_flops(
        jash.collatz_jash(8).validate().graph_module)


def test_flops_estimate_counts_matrix_products_and_elementwise_work():
    _, tj = _matrix_pair(0.5)
    got = authority.count_flops(tj.validate().graph_module)
    # 2·M·N·K for the product; one per element for the `&`, the add of
    # the arange (M·K), the final `&`; one per summed element (M·N)
    assert got == 2 * MM * MM * MM + 1 + MM * MM + MM * MM + 1


def test_queue_pops_in_the_reference_order():
    """Collatz (no matrix product, low importance) against the matrix jash
    (important): both RAs rank the matrix jash above collatz and publish
    the two in the same order."""
    jc, tc = _pair(max_steps=64, importance=0.01)
    jm, tm = _matrix_pair(0.9)
    jra = jauth.RuntimeAuthority()
    ra = authority.RuntimeAuthority(device=CPU)
    jprio = {j.name: jra.submit(j).priority for j in (jc, jm)}
    prio = {j.name: ra.submit(j).priority for j in (tc, tm)}
    hi, lo = sorted(jprio, key=jprio.get, reverse=True)
    assert (hi, lo) == (jm.name, jc.name), jprio
    assert prio[hi] > prio[lo], prio
    assert [jra.publish_next()[0].name for _ in range(2)] == [hi, lo]
    assert [ra.publish_next()[0].name for _ in range(2)] == [hi, lo]
