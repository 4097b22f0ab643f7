"""GAN inversion on the port against the JAX package, on the CPU.

The generator, the target and the round-0 jash id equal the reference's;
the grid's latent draws for a batch of args equal the port's own scalar
draws bit for bit and the reference's within ``NORMAL_TOL``
(``repro_torch.random.normal`` rounds ``log1p`` differently from
``jax.random.normal`` in ~1% of the draws); each arg's round-0 result is
within 1 of the reference's; the first winner is the reference's; after 4
rounds both packages' inversion error is below 1.0; a 2-node port
network of 4 rounds converges to equal digests, recovers from its journal
and refuses a tampered round; and ``examples/torch_np_problems.py`` runs.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.chain import workload as jworkload  # noqa: E402
from repro.chain.workloads import gan as jgan  # noqa: E402
from repro.core.executor import run_optimal as jrun_optimal  # noqa: E402
from repro_torch.chain import ChainStore, Network, Node  # noqa: E402
from repro_torch.chain import workload as tworkload  # noqa: E402
from repro_torch.chain.workloads import gan as tgan  # noqa: E402
from repro_torch.core.executor import run_optimal  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
GRID_BITS = 10
# |repro_torch.random.normal - jax.random.normal| (tests/test_torch_train.py)
NORMAL_TOL = 2e-6


@pytest.fixture(scope="module")
def pair():
    return (jgan.GanInversionWorkload(seed=0, grid_bits=GRID_BITS),
            tgan.GanInversionWorkload(seed=0, grid_bits=GRID_BITS,
                                      device=CPU))


def test_problem_and_round_0_jash_id_equal_the_references(pair):
    j, t = pair
    for name in ("_w1", "_w2", "_z_true", "_x_target"):
        want, got = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 4 * NORMAL_TOL, name
    assert t.state_digest() == j.state_digest()
    assert t._round_jash().source_id() == j._round_jash().source_id()


def test_latent_draws_equal_the_scalar_calls_and_the_references(pair):
    j, t = pair
    args = np.arange(1 << GRID_BITS, dtype=np.uint32)
    got = t._draws(torch.arange(1 << GRID_BITS)).numpy()
    # each row of the batched draw is the port's scalar draw, bit for bit
    for a in (0, 1, 2, 511, 1023):
        scalar = t._draws(torch.tensor([a]))[0].numpy()
        assert np.array_equal(got[a].view(np.int32), scalar.view(np.int32))
    want = np.asarray(jax.vmap(lambda a: jax.random.normal(
        jax.random.fold_in(jax.random.key(0), a), (j.d_z,)))(
            jnp.asarray(args)))
    assert np.abs(got - want).max() <= NORMAL_TOL
    # found: 72 of the 8,192 values differ, by at most 2.4e-7
    differ = int((got.view(np.int32) != want.view(np.int32)).sum())
    assert differ <= 0.02 * want.size, differ


def test_round_0_results_within_1_and_the_same_winner(pair):
    j, t = pair
    args = np.arange(1 << GRID_BITS, dtype=np.uint32)
    want = np.asarray(jax.vmap(j._round_jash().fn)(jnp.asarray(args)))
    got = t._round_jash().fn(torch.arange(1 << GRID_BITS)).numpy()
    diff = np.abs(got - want.astype(np.int64))
    # found: 41 of the 1,024 results differ, each by 1 (err * 1e4
    # truncated, err summed and rounded in another order)
    assert diff.max() <= 1
    assert (diff != 0).sum() <= 0.1 * diff.size
    jo = jrun_optimal(j._round_jash())
    to = run_optimal(t._round_jash(), device=CPU)
    assert to.best_arg == jo.best_arg
    assert np.array_equal(to.best_res, np.asarray(jo.best_res))


def _mine_rounds(wl, ctx_cls, n):
    payloads = []
    for r in range(n):
        ctx = ctx_cls(height=r, prev_hash="", node_id=0)
        payloads.append(wl.mine(wl.prepare(ctx)))
    return payloads


def test_four_rounds_invert_in_both_packages():
    j = jgan.GanInversionWorkload(seed=0, grid_bits=GRID_BITS)
    t = tgan.GanInversionWorkload(seed=0, grid_bits=GRID_BITS, device=CPU)
    jp = _mine_rounds(j, jworkload.BlockContext, 4)
    tp = _mine_rounds(t, tworkload.BlockContext, 4)
    assert j.inversion_error() < 1.0 and t.inversion_error() < 1.0
    assert [p.train_height for p in tp] == [0, 1, 2, 3]
    assert tp[0].best_arg == jp[0].best_arg
    assert t.round == j.round == 4


@pytest.fixture(scope="module")
def port_network():
    journal = ChainStore()

    def node(i, **kw):
        return Node(node_id=i, classic_arg_bits=5, device=CPU, workloads={
            "gan": tgan.GanInversionWorkload(seed=0, grid_bits=GRID_BITS,
                                             device=CPU)}, **kw)
    net = Network.create(2, node_factory=lambda i: node(
        i, **({"store": journal} if i == 0 else {})))
    for b in range(4):
        res = net.mine(b % 2, "gan")
        assert not res.rejected_by, res.rejected_by
    return net, journal, node


def test_port_nodes_converge_on_equal_digests(port_network):
    net, _, _ = port_network
    a, b = (n.workloads["gan"] for n in net.nodes)
    assert net.converged()
    assert a.state_digest() == b.state_digest()
    assert a.round == 4 and a.inversion_error() < 1.0
    assert len({tuple(sorted(n.book.balances.items()))
                for n in net.nodes}) == 1
    assert all(n.audit_chain() for n in net.nodes)


def test_port_gan_recovers_and_refuses_a_tampered_round(port_network):
    net, journal, node = port_network
    a = net.nodes[0]
    rec = Node.recover(ChainStore.from_bytes(journal.to_bytes()),
                       node=node(0))
    assert rec.ledger.tip_hash == a.ledger.tip_hash
    assert rec.workloads["gan"].state_digest() == \
        a.workloads["gan"].state_digest()
    miner = tgan.GanInversionWorkload(seed=0, grid_bits=GRID_BITS,
                                      device=CPU)
    peer = tgan.GanInversionWorkload(seed=0, grid_bits=GRID_BITS,
                                     device=CPU)
    honest = _mine_rounds(miner, tworkload.BlockContext, 1)[0]
    before = peer.state_digest()
    assert not peer.verify(dataclasses.replace(honest,
                                               state_digest="0" * 64))
    assert peer.state_digest() == before and peer.is_pristine()
    assert peer.verify(honest) and peer.state_digest() == \
        miner.state_digest()


def test_np_problems_example_runs_on_the_cpu():
    """``examples/torch_np_problems.py`` ends with the reference example's
    own assertions passing (error below 1.0, equal digests and books,
    both audits)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_np_problems.py"),
         "--device", CPU], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "books bit-identical" in out.stdout.splitlines()[-1]
