"""The port's chain against the JAX package's: a 2-node network of each
mines the same schedule to the same block hashes, roots and credit books,
and a block mined by either package verifies under the other."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.chain import network as jnetwork  # noqa: E402
from repro.chain import workload as jworkload  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.core import jash as jjash  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.chain import network, node, workload  # noqa: E402
from repro_torch.core import jash  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
SCHEDULE = ["full", "optimal", None, None]


def _jash(pkg):
    base = pkg.collatz_jash(max_steps=64)
    return pkg.Jash(base.name, base.fn,
                    pkg.JashMeta(arg_bits=6, res_bits=32, importance=0.8),
                    example_args=base.example_args)


def _run(net, pkg):
    # one jash in a queue at a time: the two packages estimate priorities
    # differently, so two queued jashes could pop in another order
    for i, wl in enumerate(SCHEDULE):
        origin = i % len(net.nodes)
        if wl is not None:
            net.nodes[origin].submit(_jash(pkg))
        result = net.mine(origin=origin, workload=wl)
        assert not result.rejected_by
    return net


@pytest.fixture(scope="module")
def nets():
    ref = _run(jnetwork.Network.create(2, classic_arg_bits=8), jjash)
    port = _run(network.Network.create(2, classic_arg_bits=8, device=CPU),
                jash)
    return ref, port


def _book(n):
    return sorted(n.book.balances.items()), n.book.total_issued


def test_two_node_networks_agree_bit_for_bit(nets):
    ref, port = nets
    assert port.converged() and ref.converged()
    for rn, pn in zip(ref.nodes, port.nodes):
        assert [b.block_hash for b in pn.ledger.blocks] == \
            [b.block_hash for b in rn.ledger.blocks]
        assert [b.merkle_root for b in pn.ledger.blocks] == \
            [b.merkle_root for b in rn.ledger.blocks]
        assert [b.mode for b in pn.ledger.blocks] == SCHEDULE[:2] + \
            ["classic", "classic"]
        assert _book(pn) == _book(rn)
        assert pn.audit_chain() and pn.state().chain_valid
    ported = convert.ledger_from_json(ref.nodes[0].ledger.to_json())
    assert ported.tip_hash == port.nodes[0].ledger.tip_hash
    book = convert.credit_book_from_balances(ref.nodes[1].book.balances,
                                             ref.nodes[1].book.total_issued)
    assert (sorted(book.balances.items()), book.total_issued) == \
        _book(port.nodes[1])


def _payload_like(p, pkg_payload, jash_obj, full):
    return pkg_payload(
        workload=p.workload, jash_id=p.jash_id, merkle_root=p.merkle_root,
        n_results=p.n_results, winner=p.winner, best_res=p.best_res,
        origin=p.origin, block_reward=p.block_reward, jash=jash_obj,
        full=full, best_arg=p.best_arg)


def test_reference_blocks_verify_in_the_port(nets):
    ref, _ = nets
    full_p, opt_p, classic_p, _ = [r.receipt.payload for r in ref.log]
    f = full_p.full
    tfull = convert.full_result_from_arrays(
        f.args, f.results, f.hashes, f.miner_of, f.leaf_digests, device=CPU)
    assert tfull.commit_root() == full_p.merkle_root
    payload = _payload_like(full_p, workload.BlockPayload, _jash(jash), tfull)
    wl = workload.JashFullWorkload(device=CPU)
    assert wl.verify(payload) and wl.verify_batch([payload]) == [True]
    payload.merkle_root = "00" * 32
    assert not wl.verify(payload)
    opt = _payload_like(opt_p, workload.BlockPayload, _jash(jash), None)
    assert workload.JashOptimalWorkload(device=CPU).verify(opt)
    classic_wl = workload.ClassicSha256Workload(arg_bits=8, device=CPU)
    classic_jash = classic_wl.prepare(workload.BlockContext(0, "")).jash
    classic = _payload_like(classic_p, workload.BlockPayload, classic_jash,
                            None)
    assert classic_wl.verify(classic)


def test_port_blocks_verify_in_the_reference(nets):
    _, port = nets
    full_p, opt_p = [r.receipt.payload for r in port.log[:2]]
    f = full_p.full
    jfull = jexec.FullResult(args=f.args, results=f.results, hashes=f.hashes,
                             miner_of=f.miner_of, leaf_digests=f.leaf_digests)
    payload = _payload_like(full_p, jworkload.BlockPayload, _jash(jjash),
                            jfull)
    assert jworkload.JashFullWorkload().verify(payload)
    tampered = np.array(f.results)
    tampered[::2] ^= 1
    payload.full = jexec.FullResult(
        args=f.args, results=tampered, hashes=f.hashes, miner_of=f.miner_of,
        leaf_digests=f.leaf_digests)
    assert not jworkload.JashFullWorkload().verify(payload)
    opt = _payload_like(opt_p, jworkload.BlockPayload, _jash(jjash), None)
    assert jworkload.JashOptimalWorkload().verify(opt)


def test_fork_choice_adopts_the_longer_chain():
    a = node.Node(node_id=0, classic_arg_bits=6, device=CPU)
    b = node.Node(node_id=1, classic_arg_bits=6, device=CPU)
    a.mine_block()
    for _ in range(2):
        b.mine_block()
    assert a.consider_chain(b.ledger.blocks, b.chain_payloads())
    assert a.ledger.tip_hash == b.ledger.tip_hash
    assert _book(a) == _book(b)
    assert not b.consider_chain(a.ledger.blocks, a.chain_payloads())


def test_node_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node.Node()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        network.Network.create(2)
    node.Node(device=CPU)


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch, repro_torch.chain, repro_torch.convert,"
            " repro_torch.chain.workloads;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')];"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = list((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "chip_probes.py"]
    for path in files:
        assert not pattern.search(path.read_text()), path
