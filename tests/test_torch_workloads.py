"""The port's SAT and docking workload families against the JAX
package's: the same instances, checksums and jash ids, the same
``FullResult`` bits and roots, certificates that reject the same
forgeries, and blocks mined by either package that verify under the
other (carried across in the journal's canonical encoding).

The reference side stays at 64 leaves or fewer: its device Merkle tree
compiles too slowly above that on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.chain import workloads as jworkloads  # noqa: E402
from repro.chain.workloads import docking as jdocking  # noqa: E402
from repro.chain.workloads import sat as jsat  # noqa: E402
from repro.chain import store as jstore  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.core import ledger as jledger  # noqa: E402
from repro_torch.chain import (BlockContext, Network, Node,  # noqa: E402
                               certificate_digest, store)
from repro_torch.chain.workloads import (WORKLOAD_FAMILIES,  # noqa: E402
                                         DockingBundle, DockingWorkload,
                                         SatWorkload, default_suite,
                                         random_cnf3)
from repro_torch.core import executor  # noqa: E402

CPU = "cpu"
SAT = {"n_vars": 6, "n_clauses": 24, "seed": 7}
DOCKING = {"n_r": 8, "n_p": 8, "seed": 7}


def suite_node(i: int, **kw) -> Node:
    return Node(node_id=i, classic_arg_bits=6, device=CPU,
                workloads=default_suite(seed=7, device=CPU, sat=dict(SAT),
                                        docking=dict(DOCKING)), **kw)


def _mine_sat(node: Node, want_cert: bool):
    """Mine sat blocks until one with (or without) a certificate shows
    up — instance k = height, so the verdict varies per block."""
    for _ in range(40):
        receipt = node.mine_block("sat")
        if (receipt.payload.certificate is not None) == want_cert:
            return receipt
    raise AssertionError(f"no {'SAT' if want_cert else 'UNSAT'} instance "
                         "found in 40 blocks")


@pytest.fixture(scope="module")
def sat_blocks():
    """A certificate block and a refutation block, each mined by a node
    of its own, with a fresh peer's SAT workload to verify them."""
    cert = _mine_sat(suite_node(0), want_cert=True).payload
    refute = _mine_sat(suite_node(2), want_cert=False).payload
    return cert, refute, suite_node(1).workloads["sat"]


@pytest.mark.parametrize("n_vars,n_clauses,seed", [
    (6, 24, 7), (20, 91, 3), (3, 1, 0x7FFFFFFF + 5)])
def test_instances_checksums_and_ids_equal_the_reference(n_vars, n_clauses,
                                                         seed):
    cnf, jcnf = random_cnf3(n_vars, n_clauses, seed), \
        jsat.random_cnf3(n_vars, n_clauses, seed)
    assert cnf.cl_vars.dtype == jcnf.cl_vars.dtype
    assert np.array_equal(cnf.cl_vars, jcnf.cl_vars)
    assert np.array_equal(cnf.cl_neg, jcnf.cl_neg)
    assert cnf.checksum() == jcnf.checksum()
    assert [cnf.unsat_count(a) for a in range(1 << min(n_vars, 8))] == \
        [jcnf.unsat_count(a) for a in range(1 << min(n_vars, 8))]
    wl = SatWorkload(n_vars=n_vars, n_clauses=n_clauses, seed=seed,
                     device=CPU)
    jwl = jsat.SatWorkload(n_vars=n_vars, n_clauses=n_clauses, seed=seed)
    for k in (0, 1, 5):
        assert wl.instance(k)[1].source_id() == \
            jwl.instance(k)[1].source_id()
        assert repr(wl.instance(k)[1].meta) == repr(jwl.instance(k)[1].meta)


@pytest.mark.parametrize("n_r,n_p,seed", [(8, 8, 7), (5, 3, 0),
                                          (1024, 1024, 0)])
def test_bundles_and_docking_ids_equal_the_reference(n_r, n_p, seed):
    b, jb = DockingBundle.generate(n_r, n_p, seed), \
        jdocking.DockingBundle.generate(n_r, n_p, seed)
    assert np.array_equal(b.receptors, jb.receptors)
    assert np.array_equal(b.peptides, jb.peptides)
    assert b.checksum() == jb.checksum()
    wl = DockingWorkload(n_r=n_r, n_p=n_p, seed=seed, device=CPU)
    jwl = jdocking.DockingWorkload(n_r=n_r, n_p=n_p, seed=seed)
    assert repr(wl._jash.meta) == repr(jwl._jash.meta)
    assert wl._jash.source_id() == jwl._jash.source_id()


def _jashes(case):
    if case.startswith("sat"):
        k = int(case[-1])
        return (SatWorkload(**SAT, device=CPU).instance(k)[1],
                jsat.SatWorkload(**SAT).instance(k)[1])
    n_r, n_p = (8, 8) if case == "docking_8x8" else (5, 3)
    return (DockingWorkload(n_r=n_r, n_p=n_p, seed=7, device=CPU)._jash,
            jdocking.DockingWorkload(n_r=n_r, n_p=n_p, seed=7)._jash)


@pytest.mark.parametrize("case", ["sat_k0", "sat_k1", "sat_k2",
                                  "docking_8x8", "docking_5x3"])
@pytest.mark.parametrize("lanes", [1, 3])
def test_full_results_equal_the_reference_bit_for_bit(case, lanes):
    tj, jj = _jashes(case)
    got = executor.run_full(tj, lanes=lanes, device=CPU)
    want = jexec.run_full(jj, lanes=lanes)
    for field in ("args", "results", "hashes", "miner_of", "leaf_digests"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert np.array_equal(g, w), field
    assert got.commit_root() == jledger.merkle_root(
        list(want.merkle_leaves), backend="hashlib")
    if case == "docking_5x3":                 # max_arg not a power of two
        assert tj.meta.max_arg == 15 and len(got.args) == 15


def test_a_docking_screen_matches_a_python_loop_of_the_matcher():
    wl = DockingWorkload(n_r=40, n_p=30, seed=3, max_steps=40,
                         bind_threshold=30, device=CPU)
    full = executor.run_full(wl._jash, device=CPU)
    r, p = wl.bundle.receptors, wl.bundle.peptides

    def matcher(b):
        e = ((int(r[b % 40]) ^ int(p[b // 40])) * 2654435761
             & 0xFFFFFFFF) >> 16
        t, done = 0, False
        for _ in range(40):
            if not done and e > 100:
                e, t = e - (e >> 3) - 1, t + 1
            done = done or e <= 100
        return 0b10 if not done else (0b01 if t < 30 else 0b00)

    want = [matcher(b) for b in range(1200)]
    assert full.results[:, 0].tolist() == want
    assert len(set(want)) == 3            # every result code occurs


def test_forged_witness_rejected(sat_blocks):
    p, _, sat = sat_blocks
    witness = int(np.frombuffer(p.certificate, "<u4")[0])
    forged_arg = (witness + 1) % (1 << SAT["n_vars"])
    cert = np.uint32(forged_arg).tobytes()
    forged = dataclasses.replace(
        p, certificate=cert, state_digest=certificate_digest(cert),
        winner=(p.origin * 65536) + forged_arg % p.n_miners)
    assert sat.verify(p)
    assert not sat.verify(forged)
    assert sat.verify_batch([p, forged]) == [True, False]


def test_stripped_or_grafted_certificate_rejected(sat_blocks):
    sat_p, unsat_p, sat = sat_blocks
    stripped = dataclasses.replace(sat_p, certificate=None)
    assert not sat.verify(stripped)
    lazy = dataclasses.replace(sat_p, certificate=None, state_digest="",
                               winner=None)
    assert not sat.verify(lazy)
    cert = np.uint32(0).tobytes()
    grafted = dataclasses.replace(
        unsat_p, certificate=cert, state_digest=certificate_digest(cert),
        winner=unsat_p.origin * 65536)
    assert not sat.verify(grafted)
    assert sat.verify_batch([stripped, lazy, grafted]) == [False] * 3


def test_corrupted_refutation_table_rejected(sat_blocks):
    _, p, sat = sat_blocks
    bad = p.full.results.copy()
    bad[3, 0] ^= 1
    forged = dataclasses.replace(
        p, full=dataclasses.replace(p.full, results=bad))
    assert sat.verify(p) and not sat.verify(forged)
    assert sat.verify_batch([forged, p]) == [False, True]


def test_forged_certificate_rejected_on_network_receive():
    net = Network.create(2, node_factory=suite_node)
    receipt = _mine_sat(net.nodes[0], want_cert=True)
    cert = np.uint32((int.from_bytes(receipt.payload.certificate,
                                     "little") + 1) % 64).tobytes()
    forged = dataclasses.replace(
        receipt.payload, certificate=cert,
        state_digest=certificate_digest(cert))
    blk = dataclasses.replace(receipt.record.to_block(),
                              state_digest=forged.state_digest)
    assert not net.nodes[1].receive(blk, forged, origin=0)


def test_a_tampered_bundle_rejects_an_honest_block():
    net = Network.create(2, node_factory=suite_node)
    res = net.mine(0, "docking")
    assert not res.rejected_by
    p = res.receipt.payload
    bundle = net.nodes[0].workloads["docking"].bundle
    tampered = DockingBundle(receptors=bundle.receptors ^ 1,
                             peptides=bundle.peptides)
    bad_peer = Node(node_id=9, device=CPU, workloads={
        "docking": DockingWorkload(bundle=tampered, device=CPU)})
    assert not bad_peer.receive(res.receipt.record.to_block(), p, origin=0)
    bad_results = p.full.results.copy()
    bad_results[0, 0] ^= 1
    forged = dataclasses.replace(
        p, full=dataclasses.replace(p.full, results=bad_results))
    assert not net.nodes[1].workloads["docking"].verify(forged)
    # two screenings of one bundle are byte-identical: one verifies both
    again = net.mine(1, "docking").receipt.payload
    assert again.merkle_root == p.merkle_root
    assert net.nodes[0].workloads["docking"].verify_batch(
        [p, again, forged]) == [True, True, False]


def _mined(pkg_sat, pkg_docking, want_cert, **dev):
    """A SAT block of the wanted kind and a docking block, mined by one
    package's workloads (no node: the reference's self-verify is not what
    is under test)."""
    sat = pkg_sat.SatWorkload(**SAT, **dev)
    for k in range(40):
        p = sat.mine(sat.prepare(BlockContext(height=k, prev_hash="")))
        if (p.certificate is not None) == want_cert:
            break
    docking = pkg_docking.DockingWorkload(**DOCKING, **dev)
    return p, docking.mine(docking.prepare(BlockContext(height=0,
                                                        prev_hash="")))


@pytest.mark.parametrize("want_cert", [True, False])
def test_blocks_verify_across_packages(want_cert):
    from repro.chain import workload as jworkload
    from repro_torch.chain.workloads import docking, sat
    port_blocks = _mined(sat, docking, want_cert, device=CPU)
    jctx = jworkload.BlockContext(height=0, prev_hash="")
    ref_sat = jsat.SatWorkload(**SAT)
    for k in range(40):
        jp = ref_sat.mine(ref_sat.prepare(dataclasses.replace(jctx,
                                                              height=k)))
        if (jp.certificate is not None) == want_cert:
            break
    jdock = jdocking.DockingWorkload(**DOCKING)
    ref_blocks = (jp, jdock.mine(jdock.prepare(jctx)))
    assert (jp.certificate is not None) == want_cert
    for p, jp in zip(port_blocks, ref_blocks):
        assert store.encode_payload(p) == jstore.encode_payload(jp)
    # each package's blocks, through the canonical encoding, under the
    # other's verifiers
    tsat, tdock = SatWorkload(**SAT, device=CPU), \
        DockingWorkload(**DOCKING, device=CPU)
    for jp, wl in zip(ref_blocks, (tsat, tdock)):
        p = store.decode_payload(jstore.encode_payload(jp))
        assert wl.verify(p) and wl.verify_batch([p]) == [True]
    jsat_v, jdock_v = jsat.SatWorkload(**SAT), \
        jdocking.DockingWorkload(**DOCKING)
    for p, wl in zip(port_blocks, (jsat_v, jdock_v)):
        jp = jstore.decode_payload(store.encode_payload(p))
        assert wl.verify(jp) and wl.verify_batch([jp]) == [True]


def test_default_suite_holds_the_ported_families_only():
    suite = default_suite(seed=3, device=CPU, sat={"n_vars": 5})
    assert sorted(suite) == ["docking", "gan", "model_train", "sat"]
    assert sorted(suite) == sorted(jworkloads.WORKLOAD_FAMILIES)
    assert suite["sat"].n_vars == 5 and suite["sat"].seed == 3
    assert all(wl.device == torch.device(CPU) for wl in suite.values())
    for name, cls in WORKLOAD_FAMILIES.items():
        assert cls.name == name
    with pytest.raises(ValueError, match="no ported workload family"):
        default_suite(device=CPU, nonesuch={})
    with pytest.raises(ValueError, match="registry key must match"):
        Node(device=CPU, workloads={"mislabeled": SatWorkload(device=CPU)})


def test_default_suite_gan_mines_a_round():
    suite = default_suite(seed=1, device=CPU, gan={"grid_bits": 6})
    gan = suite["gan"]
    assert (gan.grid_bits, gan.seed) == (6, 1)
    node = Node(device=CPU, workloads=suite)
    receipt = node.mine_block("gan")
    assert receipt.payload.n_results == 1 << 6
    assert receipt.payload.train_height == 0 and gan.round == 1
    assert 0 <= receipt.payload.best_arg < 1 << 6
    assert node.audit_chain()
