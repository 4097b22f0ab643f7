"""The port's chain journal against the JAX package's: the same schedule
of blocks (collatz full, optimal, SAT, docking, Classic) journaled by a
reference ``Node`` and a port ``Node`` gives the same bytes; a journal
written by either package recovers through the other to the same tip and
balances; the same damaged bytes give the same ``RecoveryReport`` in both;
and the two quickstart examples print the same blocks.

Every tree the reference builds here has 64 leaves or fewer: its device
Merkle tree compiles too slowly above that on the CPU."""
import dataclasses
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.chain import node as jnode  # noqa: E402
from repro.chain import store as jstore  # noqa: E402
from repro.chain import workload as jworkload  # noqa: E402
from repro.chain.workloads import docking as jdocking  # noqa: E402
from repro.chain.workloads import sat as jsat  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.core import jash as jjash  # noqa: E402
from repro.core import ledger as jledger  # noqa: E402
from repro_torch.chain import (ChainError, ChainStore, Node,  # noqa: E402
                               RecoveryReport, store, workload)
from repro_torch.chain import node as pnode  # noqa: E402
from repro_torch.chain.workloads import (DockingWorkload,  # noqa: E402
                                         SatWorkload)
from repro_torch.core import jash  # noqa: E402
from repro_torch.kernels.native import KernelLaunchError  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
SCHEDULE = ("full", "optimal", "sat", "docking", "classic")
SAT = {"n_vars": 6, "n_clauses": 24, "seed": 7}
DOCKING = {"n_r": 8, "n_p": 8, "seed": 7}
CLASSIC_BITS = 6


def _collatz(pkg):
    base = pkg.collatz_jash(max_steps=64)
    return pkg.Jash(base.name, base.fn,
                    pkg.JashMeta(arg_bits=6, res_bits=32, importance=0.9),
                    example_args=base.example_args)


def _port_workloads():
    return {"full": workload.JashFullWorkload(device=CPU),
            "optimal": workload.JashOptimalWorkload(device=CPU),
            "classic": workload.ClassicSha256Workload(
                arg_bits=CLASSIC_BITS, device=CPU),
            "sat": SatWorkload(**SAT, device=CPU),
            "docking": DockingWorkload(**DOCKING, device=CPU)}


def _ref_workloads():
    return {"full": jworkload.JashFullWorkload(),
            "optimal": jworkload.JashOptimalWorkload(),
            "classic": jworkload.ClassicSha256Workload(
                arg_bits=CLASSIC_BITS),
            "sat": jsat.SatWorkload(**SAT),
            "docking": jdocking.DockingWorkload(**DOCKING)}


class _Side:
    """One package's side of the comparison: a journaled donor that mined
    the schedule, and workload instances shared by every recovery shell
    (stateless families, so sharing them between shells is sound and
    keeps the reference's compiled functions cached across recoveries)."""

    def __init__(self, pkg_node, pkg_store, jash_pkg, workloads, **kw):
        self.node_cls, self.store_cls, self.kw = pkg_node.Node, \
            pkg_store.ChainStore, kw
        self.collatz = _collatz(jash_pkg)
        self.fns = {self.collatz.name: self.collatz.fn}
        self.workloads = workloads
        self.donor = self.shell(store=self.store_cls())
        for family in SCHEDULE:
            if family in ("full", "optimal"):
                self.donor.submit(self.collatz)
            self.donor.mine_block(family)

    def shell(self, **extra):
        return self.node_cls(node_id=0, classic_arg_bits=CLASSIC_BITS,
                             workloads=dict(self.workloads), **self.kw,
                             **extra)

    def recover(self, data: bytes):
        return self.node_cls.recover(self.store_cls.from_bytes(data),
                                     node=self.shell(), jash_fns=self.fns)


@pytest.fixture(scope="module")
def sides():
    ref = _Side(jnode, jstore, jjash, _ref_workloads())
    port = _Side(pnode, store, jash, _port_workloads(), device=CPU)
    return ref, port


def _book(n):
    return sorted(n.book.balances.items()), n.book.total_issued


def _training_payload(pkg):
    return pkg.BlockPayload(
        workload="training", jash_id="t" * 64, merkle_root="m" * 64,
        n_results=1, winner=2, state_digest="s" * 64, origin=1,
        block_reward=9.5, loss=0.125, train_height=3, n_miners=2,
        micro_proof=np.arange(128, dtype=np.uint8).reshape(2, 64))


@pytest.mark.parametrize("family", SCHEDULE + ("training",))
def test_round_trip_is_the_identity_on_bytes(sides, family):
    ref, port = sides
    if family == "training":
        payloads = [(_training_payload(workload),
                     _training_payload(jworkload), None, None)]
    else:
        h = SCHEDULE.index(family)
        payloads = [(port.donor.chain_payloads()[h],
                     ref.donor.chain_payloads()[h],
                     port.donor.ledger.blocks[h],
                     ref.donor.ledger.blocks[h])]
    for p, rp, blk, rblk in payloads:
        assert p.workload == family
        pe = store.encode_payload(p)
        decoded = store.decode_payload(pe, jash_fns=port.fns)
        assert store.encode_payload(decoded) == pe
        assert pe == jstore.encode_payload(rp)
        assert store.payload_checksum(p) == jstore.payload_checksum(rp)
        # the reference's bytes decode in the port to the same bytes
        assert store.encode_payload(store.decode_payload(
            jstore.encode_payload(rp))) == pe
        if blk is None:
            assert dataclasses.replace(decoded, micro_proof=None) == \
                dataclasses.replace(p, micro_proof=None)
            assert decoded.micro_proof.dtype == np.uint8
            assert np.array_equal(decoded.micro_proof, p.micro_proof)
            continue
        assert decoded.full is None or decoded.full.device is None
        be = store.encode_block(blk)
        blk2 = store.decode_block(be)
        assert store.encode_block(blk2) == be == jstore.encode_block(rblk)
        assert blk2.block_hash == blk.block_hash == rblk.block_hash


def test_journal_bytes_equal_the_reference(sides):
    ref, port = sides
    assert [b.mode for b in port.donor.ledger.blocks] == list(SCHEDULE)
    assert port.donor.store.to_bytes() == ref.donor.store.to_bytes()
    assert port.donor.ledger.tip_hash == ref.donor.ledger.tip_hash
    assert _book(port.donor) == _book(ref.donor)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_a_journal_recovers_through_the_other_package(sides, direction):
    ref, port = sides
    writer, reader = (ref, port) if direction == "reference_to_port" \
        else (port, ref)
    node = reader.recover(writer.donor.store.to_bytes())
    rec = node.last_recovery
    assert (rec.replayed, rec.adopted_height, rec.truncated_records,
            rec.resynced_height) == (5, 5, 0, 5)
    assert node.ledger.tip_hash == writer.donor.ledger.tip_hash
    assert _book(node) == _book(writer.donor)
    assert node.audit_chain() and node.state().chain_valid


def _damaged(data: bytes, spans, case: str) -> bytes:
    last_start, last_end = spans[-1]
    if case == "torn_last_byte":
        return data[:-1]
    if case == "torn_9_bytes":
        return data[:-9]
    if case == "torn_mid_last":
        return data[:(last_start + last_end) // 2]
    if case == "torn_into_docking":
        return data[:spans[3][0] + 7]
    if case == "torn_after_magic":
        return data[:len(jstore.MAGIC) + 3]
    assert case == "bitflip_in_sat"
    out = bytearray(data)
    out[(spans[2][0] + spans[2][1]) // 2] ^= 1 << 5
    return bytes(out)


@pytest.mark.parametrize("case", [
    "torn_last_byte", "torn_9_bytes", "torn_mid_last", "torn_into_docking",
    "torn_after_magic", "bitflip_in_sat"])
def test_damaged_bytes_give_equal_recovery_reports(sides, case):
    ref, port = sides
    data = port.donor.store.to_bytes()
    bad = _damaged(data, port.donor.store._record_spans(), case)
    read = ChainStore.from_bytes(bad).read_chain(jash_fns=port.fns)
    jread = jstore.ChainStore.from_bytes(bad).read_chain(jash_fns=ref.fns)
    assert (read.records_read, read.truncated_records, read.clean) == \
        (jread.records_read, jread.truncated_records, jread.clean)
    assert [b.block_hash for b in read.blocks] == \
        [b.block_hash for b in jread.blocks]
    node, jnode_ = port.recover(bad), ref.recover(bad)
    rep = node.last_recovery
    assert dataclasses.asdict(rep) == dataclasses.asdict(
        jnode_.last_recovery)
    assert rep.truncated_records >= 1 and rep.adopted_height < 5
    assert node.ledger.tip_hash == jnode_.ledger.tip_hash
    assert _book(node) == _book(jnode_)
    # the damaged journal was compacted to the adopted prefix
    assert node.store.read_chain().clean
    assert node.store.to_bytes() == jnode_.store.to_bytes()


def test_a_torn_tail_resyncs_from_a_peer(sides):
    _, port = sides
    donor = port.donor
    damaged = ChainStore.from_bytes(donor.store.to_bytes()[:-100])
    node = Node.recover(damaged, peers=[donor], node=port.shell(),
                        jash_fns=port.fns)
    assert node.last_recovery == RecoveryReport(
        replayed=4, adopted_height=4, truncated_records=1,
        resynced_height=5)
    assert node.ledger.tip_hash == donor.ledger.tip_hash
    assert _book(node) == _book(donor)


def test_a_fault_of_the_card_in_a_replay_raises_and_keeps_the_journal(
        sides, monkeypatch):
    _, port = sides
    data = port.donor.store.to_bytes()
    journal = ChainStore.from_bytes(data)
    shell = port.shell()

    def fault(payloads):
        raise KernelLaunchError("sha256_rows_cuda: kernel launch failed")
    monkeypatch.setattr(shell.workloads["sat"], "verify_batch", fault)
    with pytest.raises(KernelLaunchError):
        Node.recover(journal, node=shell, jash_fns=port.fns)
    assert journal.to_bytes() == data          # nothing truncated


def test_a_used_store_and_a_used_shell_are_refused(sides):
    _, port = sides
    used = ChainStore.from_bytes(port.donor.store.to_bytes())
    with pytest.raises(ValueError, match="Node.recover"):
        Node(classic_arg_bits=4, device=CPU, store=used)
    mined = Node(node_id=1, classic_arg_bits=4, device=CPU)
    mined.mine_block()
    with pytest.raises(ChainError, match="fresh node shell"):
        Node.recover(used, node=mined)
    with pytest.raises(ChainError, match="fresh node shell"):
        Node.recover(used, node=Node(classic_arg_bits=4, device=CPU,
                                     store=ChainStore()))


def test_a_reorg_journals_a_truncate_and_replays_through_it(tmp_path):
    a = Node(node_id=0, classic_arg_bits=5, device=CPU,
             store=ChainStore(tmp_path / "a.journal"))
    base = jash.collatz_jash(max_steps=32)
    job = jash.Jash(base.name, base.fn,
                    jash.JashMeta(arg_bits=5, res_bits=32, importance=0.9),
                    example_args=base.example_args)
    a.submit(job)
    a.mine_block("optimal")            # diverges from b at height 0
    a.mine_block()
    b = Node(node_id=1, classic_arg_bits=5, device=CPU)
    for _ in range(3):
        b.mine_block()
    assert a.consider_chain(b.ledger.blocks, b.chain_payloads())
    # 2 commits, TRUNCATE(0), 3 commits, folding to b's chain
    data = a.store.to_bytes()
    kinds = [data[s] for s, _ in a.store._record_spans()]
    assert kinds == [store.REC_COMMIT] * 2 + [store.REC_TRUNCATE] + \
        [store.REC_COMMIT] * 3
    read = a.store.read_chain()
    assert read.clean and read.records_read == 6 and len(read.blocks) == 3
    node = Node.recover(ChainStore(tmp_path / "a.journal"),
                        node=Node(node_id=0, classic_arg_bits=5,
                                  device=CPU))
    assert node.ledger.tip_hash == b.ledger.tip_hash
    assert _book(node) == _book(b)


def test_garbage_raises_chain_error_and_never_crashes_a_read():
    with pytest.raises(ChainError):
        store.decode_payload(b"not a journal body")
    with pytest.raises(ChainError):
        store.decode_block(b"\x00" * 8)
    read = ChainStore.from_bytes(b"garbage" * 16).read_chain()
    assert not read.clean and read.blocks == [] and \
        read.truncated_records == 1
    node = Node.recover(ChainStore.from_bytes(b"garbage" * 16),
                        classic_arg_bits=4, device=CPU)
    assert node.ledger.height == 0 and node.last_recovery.adopted_height == 0


def _printed_blocks(out: str):
    """The workloads, result counts, roots and tip a quickstart printed
    (RA timings and block times left out)."""
    lines = [ln.split(" mined+verified")[0] for ln in out.splitlines()
             if ln.startswith("block ")]
    tip = [ln.split("tip=")[1] for ln in out.splitlines() if "tip=" in ln]
    return lines, tip


def test_the_quickstart_examples_print_the_same_chain(monkeypatch, capsys):
    # the reference commits its 1,024-leaf root with its device tree,
    # whose compile this CPU cannot afford; its hashlib tree gives the same
    # root (the reference's own tests hold the two equal)
    monkeypatch.setattr(
        jexec.FullResult, "commit_root",
        lambda self: jledger.merkle_root(list(self.merkle_leaves),
                                         backend="hashlib"))
    runpy.run_path(str(REPO / "examples" / "quickstart.py"),
                   run_name="__main__")
    ref_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["torch_quickstart.py", "--device",
                                      CPU])
    runpy.run_path(str(REPO / "examples" / "torch_quickstart.py"),
                   run_name="__main__")
    port_out = capsys.readouterr().out
    blocks, tip = _printed_blocks(port_out)
    assert [b.split()[2] for b in blocks] == ["FULL", "CLASSIC", "CLASSIC"]
    assert all("1024 results" in b for b in blocks)
    assert (blocks, tip) == _printed_blocks(ref_out) and len(tip) == 1
    assert "ledger verified: True" in port_out
    # the reference's roots and tip as chip_smoke.py checks them on the card
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"))
    assert tuple(b.split("root=")[1].rstrip("…") for b in blocks) == \
        smoke["QUICKSTART_ROOTS"]
    assert tip[0].rstrip("…") == smoke["QUICKSTART_TIP"]
