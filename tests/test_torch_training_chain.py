"""The port's proof-of-useful-work training chain within itself, on the CPU:
a 2-node ``Network`` of ``TrainingWorkload`` (``core.pow_train.
PoUWTrainer`` at ``pnpcoin-micro``'s size) in full and in optimal (ES,
8 candidates, a fixed batch) mode converges bit for bit, audits its
chain, recovers a node from its journal and reorgs a losing private block;
a payload with a tampered state digest is refused and leaves the trainer
as it was; ``examples/torch_train_pnp.py`` runs at a small shape; and no
module of the port imports JAX or the reference. The comparisons with the
JAX package are ``tests/test_torch_pow_train.py``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.chain import (ChainStore, Network, Node,  # noqa: E402
                               TrainingWorkload)
from repro_torch.chain.workload import BlockContext  # noqa: E402
from repro_torch.chain.workloads import model_train as tmt  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core.pow_train import PoUWTrainer  # noqa: E402
from repro_torch.core.rewards import CreditBook  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
SHAPE = (16, 2)                 # seq, batch: MICRO_KWARGS' shape
HP = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)
ES = dict(pop_size=8, sigma=0.02)


def _factory(mode: str):
    kw = dict(ES, fixed_batch=True) if mode == "optimal" else {}
    return lambda: PoUWTrainer(
        tmt.MICRO_CONFIG, InputShape("t", *SHAPE, "train"),
        hp=tsteps.TrainHparams(**HP), mode=mode, n_miners=4, device=CPU, **kw)


def _node(i: int, mode: str, **kw) -> Node:
    return Node(node_id=i, classic_arg_bits=5, device=CPU, workloads={
        "training": TrainingWorkload(_factory(mode))}, **kw)


def _digest_of(wl: TrainingWorkload) -> str:
    return tsteps.params_digest(wl.trainer.state)


def _digest(node: Node) -> str:
    return _digest_of(node.workloads["training"])


@pytest.fixture(scope="module", params=["full", "optimal"])
def port_chain(request):
    mode, journal = request.param, ChainStore()
    net = Network.create(2, node_factory=lambda i: _node(
        i, mode, **({"store": journal} if i == 0 else {})))
    for b in range(3):
        res = net.mine(b % 2, "training")
        assert not res.rejected_by, res.rejected_by
    return mode, net, journal


def test_training_network_converges_and_audits(port_chain):
    mode, net, _ = port_chain
    a, b = net.nodes
    assert net.converged()
    assert _digest(a) == _digest(b)
    assert len({tuple(sorted(n.book.balances.items()))
                for n in net.nodes}) == 1
    assert all(n.audit_chain() for n in net.nodes)
    payloads = a.chain_payloads()
    assert [p.train_height for p in payloads] == [0, 1, 2]
    losses = [p.loss for p in payloads]
    assert all(np.isfinite(losses))
    if mode == "optimal":
        # fixed batch, candidate 0 the incumbent: the loss never rises
        assert losses == sorted(losses, reverse=True)
        assert all(p.winner // (1 << 16) == p.origin for p in payloads)
    else:
        assert all(p.winner is None and p.n_miners == 4 for p in payloads)


def test_training_chain_recovers_and_reorgs(port_chain):
    mode, net, journal = port_chain
    a, b = net.nodes
    rec = Node.recover(ChainStore.from_bytes(journal.to_bytes()),
                       node=_node(0, mode))
    assert rec.last_recovery.adopted_height == a.ledger.height
    assert rec.ledger.tip_hash == a.ledger.tip_hash
    assert _digest(rec) == _digest(a)
    assert rec.book.balances == a.book.balances
    # a private training block at height 3 against a public Classic block
    # there and a training block on top: adopting the longer chain must
    # unwind the private step (a full-mode training block mined on the
    # same state by either node has the same header bits)
    rec.mine_block("training")
    b.mine_block("classic")
    r4 = b.mine_block("training")
    assert rec.consider_chain(list(b.ledger.blocks), b.chain_payloads())
    trainer = rec.workloads["training"].trainer
    assert trainer.ledger.height == r4.payload.train_height + 1 == 4
    assert rec.ledger.tip_hash == b.ledger.tip_hash
    assert _digest(rec) == _digest(b)
    assert rec.book.balances == b.book.balances


def test_a_tampered_state_digest_is_refused_and_changes_nothing():
    miner, peer = (TrainingWorkload(_factory("full")) for _ in range(2))
    ctx = BlockContext(height=0, prev_hash="", node_id=1)
    honest = miner.mine(miner.prepare(ctx))
    before = _digest_of(peer)
    forged = dataclasses.replace(honest, state_digest="0" * 64)
    assert peer.verify(forged) is False
    t = peer.trainer
    assert (t.ledger.height, t.history, t.book.total_issued) == (0, [], 0.0)
    assert _digest_of(peer) == before
    assert peer.verify(honest) is True
    assert _digest_of(peer) == _digest_of(miner)
    assert peer.reward(CreditBook(), honest) == tuple(
        ((1 << 16) + m, 50.0 / 4) for m in range(4))


def test_port_imports_neither_jax_nor_the_reference_when_jax_raises():
    """Every module of the port, and chip_smoke.py, import in a process
    where importing jax, jaxlib or repro raises."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("refused: " + name)

        sys.meta_path.insert(0, Refuse())
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__,
                                         "repro_torch."):
            importlib.import_module(mod.name)
        import chip_smoke
        try:
            import jax
        except ImportError:
            pass
        else:
            raise SystemExit("jax imported")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_train_pnp_example_runs_on_the_cpu():
    """``examples/torch_train_pnp.py`` at a small shape ends with the
    reference example's assertion (a valid chain) and its summary."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_pnp.py"),
         "--device", CPU, "--blocks", "2", "--batch", "2", "--seq", "16"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[-1].startswith("done: 2 blocks")
