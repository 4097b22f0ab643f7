"""The port's training slice against the JAX package, on the CPU.

(a) ``repro_torch.random`` draws ``jax.random``'s threefry stream: key
words, splits, fold-ins, bits, ``randint`` and ``bernoulli`` bit for bit,
and so the token batches of ``SyntheticTokenPipeline``; ``normal`` within
the difference its ``erf_inv`` leaves. (b) The canonical digests and the
jash ids equal the reference's. (c) The loss, its gradients and one
training step on ``MICRO_CONFIG`` and at ``pnpcoin-demo``'s widths with
one layer, AdamW and the cosine schedule, and the flash backward's plain
twin against autograd and ``jax.grad``. (d) A 2-node port network
chain-trains ``MICRO_KWARGS`` blocks, recovers and reorgs; blocks of one
package fail the other's re-execution cleanly (float training differs in
the last bits between XLA and torch); and the port's example runs.
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

from repro.chain import Node as JNode  # noqa: E402
from repro.chain import store as jstore  # noqa: E402
from repro.chain.workloads import model_train as jmt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.data.pipeline import SyntheticTokenPipeline as JPipe  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedule import cosine_schedule as jcosine  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.chain import ChainStore, Network, Node, store  # noqa: E402
from repro_torch.chain.workloads import model_train as tmt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenPipeline  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
HP = dict(warmup_steps=4, total_steps=512)
# the worst ``normal`` difference from jax.random.normal, std 1 (the
# uniform it starts from is bit-identical; only log1p inside erf_inv may
# round differently): 4.77e-7 over 2.6M draws of 40 keys
NORMAL_TOL = 2e-6


def _words(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _t(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _paths(tree):
    return dict(tsteps._flatten_with_path(tree))


def _jpaths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


# -- (a) the threefry stream --------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, 2**33 + 5])
def test_key_split_fold_in_and_bits_equal_jax(seed):
    jk, tk = jax.random.key(seed), trandom.key(seed)
    assert np.array_equal(_words(jax.random.key_data(jk)), _t(tk))
    for n in (2, 3, 8):
        assert np.array_equal(_words(jax.random.key_data(
            jax.random.split(jk, n))), _t(trandom.split(tk, n)))
    for data in (0, 1, 5, 2**31 + 3):
        assert np.array_equal(_words(jax.random.key_data(
            jax.random.fold_in(jk, data))), _t(trandom.fold_in(tk, data)))
    for shape in ((1,), (5,), (3, 4), (7, 3, 2)):
        assert np.array_equal(_words(jax.random.bits(jk, shape)),
                              _t(trandom.bits(tk, shape)))


@pytest.mark.parametrize("lo,hi", [(0, 2048), (0, 16), (0, 128), (-5, 1000)])
def test_randint_bernoulli_and_uniform_equal_jax(lo, hi):
    for seed in range(3):
        jk, tk = jax.random.key(seed), trandom.key(seed)
        for shape in ((4, 1), (4, 32), (3, 5, 7)):
            assert np.array_equal(
                np.asarray(jax.random.randint(jk, shape, lo, hi)),
                _t(trandom.randint(tk, shape, lo, hi)))
            assert np.array_equal(
                np.asarray(jax.random.bernoulli(jk, 0.05, shape)),
                _t(trandom.bernoulli(tk, 0.05, shape)))
            assert np.array_equal(
                np.asarray(jax.random.uniform(jk, shape)),
                _t(trandom.uniform(tk, shape)))


def test_normal_within_its_stated_tolerance():
    worst, differ, total = 0.0, 0, 0
    for seed in range(4):
        want = np.asarray(jax.random.normal(jax.random.key(seed), (65536,),
                                            jnp.float32))
        got = _t(trandom.normal(trandom.key(seed), (65536,)))
        worst = max(worst, float(np.abs(want - got).max()))
        differ += int((want.view(np.int32) != got.view(np.int32)).sum())
        total += want.size
    # found: worst 4.77e-7, and about 1% of the values differ in their bits
    assert worst <= NORMAL_TOL, worst
    assert differ < 0.05 * total, (differ, total)


@pytest.fixture(scope="module")
def demo_pipes():
    jcfg, tcfg = jget_config("pnpcoin-demo"), get_config("pnpcoin-demo")
    return (JPipe(jcfg, JInputShape("chain32x4", 32, 4, "train")),
            SyntheticTokenPipeline(tcfg, InputShape("chain32x4", 32, 4,
                                                    "train")))


def test_pipeline_batches_equal_the_references(demo_pipes):
    jp, tp = demo_pipes
    assert tp.checksum() == jp.checksum()
    pairs = [(jp.batch(s), tp.batch(s)) for s in range(4)]
    pairs += [(jp.microbatch(h, m), tp.microbatch(h, m))
              for h in range(4) for m in range(3)]
    for jb, tb in pairs:
        assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
        for key in jb:
            assert tb[key].dtype == torch.int32
            assert np.array_equal(np.asarray(jb[key]), _t(tb[key]))
        # (b) the batch digest the proof rows commit
        assert tsteps.tree_digest(tb) == jsteps.tree_digest(jb)
    with pytest.raises(ValueError):
        tp.microbatch(0, -1)


# -- (b) digests and jash ids -------------------------------------------------

@pytest.mark.parametrize("cfg_name", ["pnpcoin-micro", "pnpcoin-demo"])
def test_params_digest_of_converted_params_equals_the_references(cfg_name):
    jcfg = jmt.MICRO_CONFIG if cfg_name == "pnpcoin-micro" \
        else jget_config(cfg_name)
    state = jsteps.make_train_state(jcfg, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, state.params),
                             device=CPU)
    assert tsteps.params_digest(params) == jsteps.params_digest(state)
    assert tsteps.params_digest(tsteps.TrainState(params, None)) == \
        jsteps.params_digest(state)


@pytest.mark.parametrize("kwargs", ["micro", "demo"])
def test_jash_id_equals_the_references(kwargs):
    jkw = dict(jmt.MICRO_KWARGS) if kwargs == "micro" else {}
    tkw = dict(tmt.MICRO_KWARGS) if kwargs == "micro" else {}
    jwl = jmt.ModelTrainingWorkload(**jkw)
    twl = tmt.ModelTrainingWorkload(device=CPU, **tkw)
    assert twl._consensus_checksum() == jwl._consensus_checksum()
    assert twl._step_jash().source_id() == jwl._step_jash().source_id()


def test_key_init_draws_the_references_weights():
    cfg, jcfg = get_config("pnpcoin-demo"), jget_config("pnpcoin-demo")
    got = _paths(build_model(cfg).init(trandom.key(3)))
    want = _jpaths(jbuild(jcfg).init(jax.random.key(3)))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].shape == leaf.shape and got[path].dtype == \
            torch.float32
        # 0.02 * normal for the embedding, d_in**-0.5 * normal elsewhere
        assert np.abs(_t(got[path]) - leaf).max() <= NORMAL_TOL, path


# -- (c) loss, gradients, one step -------------------------------------------

def _one_layer_demo(pkg):
    return dataclasses.replace(
        (get_config if pkg == "torch" else jget_config)("pnpcoin-demo"),
        n_layers=1)


@pytest.fixture(scope="module", params=["micro", "demo-1-layer"])
def step_case(request):
    """Reference and port: the loss and gradients at the reference's
    initial params (converted), and the params after one training step."""
    if request.param == "micro":
        jcfg, tcfg, shape = jmt.MICRO_CONFIG, tmt.MICRO_CONFIG, (16, 2)
    else:
        jcfg, tcfg, shape = _one_layer_demo("jax"), _one_layer_demo("torch"), \
            (32, 4)
    name = f"chain{shape[0]}x{shape[1]}"
    jb = JPipe(jcfg, JInputShape(name, *shape, "train")).microbatch(1, 1)
    tb = SyntheticTokenPipeline(tcfg, InputShape(name, *shape,
                                                 "train")).microbatch(1, 1)
    jstate = jsteps.make_train_state(jcfg, jax.random.key(0))
    # jitted, as the reference's workload runs its step
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jbuild(jcfg).loss, has_aux=True))(jstate.params, jb)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                             device=CPU)
    leaves = {k: v.requires_grad_(True) for k, v in _paths(params).items()}
    live = tsteps._unflatten(params, iter(leaves[k] for k in sorted(leaves)))
    tloss, metrics = build_model(tcfg).loss(live, tb)
    tgrads = dict(zip(sorted(leaves), torch.autograd.grad(
        tloss, [leaves[k] for k in sorted(leaves)])))
    jnew, jmet = jax.jit(jsteps.make_train_step(
        jcfg, jsteps.TrainHparams(**HP)))(jstate, jb)
    tstate = tsteps.TrainState(
        params_from_jax(jax.tree.map(np.asarray, jstate.params), device=CPU),
        tadamw.adamw_init(params))
    tnew, tmet = tsteps.make_train_step(tcfg, tsteps.TrainHparams(**HP))(
        tstate, tb)
    return dict(jloss=float(jloss), tloss=float(tloss.detach()),
                metrics=metrics, jgrads=_jpaths(jgrads), tgrads=tgrads,
                jnew=_jpaths(jnew.params), tnew=_paths(tnew.params),
                jmet=jmet, tmet=tmet)


def test_loss_equals_the_references(step_case):
    assert abs(step_case["tloss"] - step_case["jloss"]) <= \
        1e-5 * abs(step_case["jloss"])
    assert float(step_case["metrics"]["aux"]) == 0.0


def test_every_gradient_leaf_equals_jax_grad(step_case):
    jg, tg = step_case["jgrads"], step_case["tgrads"]
    assert sorted(jg) == sorted(tg)
    for path, want in jg.items():
        got = _t(tg[path])
        scale = float(np.abs(want).max())
        assert scale > 0 and np.isfinite(got).all(), path
        assert np.abs(got - want).max() <= 1e-4 * scale, path


def test_one_train_step_equals_the_references(step_case):
    lr = float(step_case["jmet"]["lr"])
    for key in ("loss", "ce", "aux", "lr"):
        tm = step_case["tmet"][key]
        assert tm.dtype == torch.float32 and tm.dim() == 0
        assert abs(float(tm) - float(step_case["jmet"][key])) <= \
            1e-5 * max(1.0, abs(float(step_case["jmet"][key])))
    for path, want in step_case["jnew"].items():
        got = _t(step_case["tnew"][path])
        assert np.abs(got - want).max() <= 2 * lr + 1e-6, path


def test_cosine_schedule_equals_the_references():
    kw = dict(peak_lr=3e-4, warmup_steps=4, total_steps=512)
    for step in (0, 1, 3, 4, 5, 100, 511, 512, 900):
        assert abs(float(cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                         **kw))
                   - float(jcosine(jnp.int32(step), **kw))) <= 1e-6 * 3e-4


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e-3])
def test_adamw_update_on_random_trees_equals_the_references(clip):
    rng = np.random.RandomState(5)
    tree = {"b": {"w": rng.randn(6, 5).astype(np.float32),
                  "bias": rng.randn(5).astype(np.float32)},
            "a": rng.randn(3, 2, 4).astype(np.float32)}
    jp, jst = jax.tree.map(jnp.asarray, tree), jadamw.adamw_init(tree)
    tp = {"b": {k: torch.from_numpy(v.copy()) for k, v in tree["b"].items()},
          "a": torch.from_numpy(tree["a"].copy())}
    tst = tadamw.adamw_init(tp)
    for step in range(3):
        g = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                         tree)
        tg = {"b": {k: torch.from_numpy(v) for k, v in g["b"].items()},
              "a": torch.from_numpy(g["a"])}
        jp, jst = jadamw.adamw_update(jp, g, jst, 1e-3, grad_clip=clip)
        tp, tst = tadamw.adamw_update(tp, tg, tst, 1e-3, grad_clip=clip)
        want, got = _jpaths(jp), _paths(tp)
        for path in want:
            assert np.abs(_t(got[path]) - want[path]).max() <= 1e-6, path
        for jm, tm in ((jst.m, tst.m), (jst.v, tst.v)):
            want, got = _jpaths(jm), _paths(tm)
            for path in want:
                assert np.abs(_t(got[path]) - want[path]).max() <= 1e-6
    assert int(tst.step) == int(jst.step) == 3


# the flash backward's plain twin: (B, S, T, H, Kv, hd, causal, window)
BWD_CASES = [
    (2, 16, 16, 2, 1, 16, True, 0),        # MICRO_CONFIG's own call (MQA)
    (2, 32, 32, 8, 4, 32, True, 0),        # pnpcoin-demo's (GQA)
    (1, 33, 33, 4, 4, 32, True, 0),        # ragged, MHA
    (2, 21, 37, 4, 2, 16, False, 0),       # S != T
    (1, 37, 21, 4, 1, 32, True, 0),        # S > T, causal
    (2, 40, 40, 6, 3, 16, True, 7),        # windowed
    (1, 50, 50, 4, 1, 32, True, 16),       # windowed MQA
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_twin_equals_autograd_and_jax_grad(case):
    B, S, T, H, Kv, hd, causal, window = case
    rng = np.random.RandomState(sum(case))
    qn, kn, vn = (rng.randn(B, n, h, hd).astype(np.float32)
                  for n, h in ((S, H), (T, Kv), (T, Kv)))
    don = rng.randn(B, S, H, hd).astype(np.float32)
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (qn, kn, vn))
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    do = torch.from_numpy(don)
    want = torch.autograd.grad(o, (q, k, v), do)
    lse = ref.flash_attention_lse_ref(q.detach(), k.detach(), v.detach(),
                                      causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      o.detach(), lse, do, causal=causal,
                                      window=window)

    def jloss(q, k, v):
        return jnp.sum(chunked_attention(q, k, v, causal=causal,
                                         window=window) * don)
    jgot = jax.grad(jloss, argnums=(0, 1, 2))(qn, kn, vn)
    for g, w, j in zip(got, want, jgot):
        assert g.shape == w.shape == j.shape
        assert float((g - w).abs().max()) <= 2e-4
        assert np.abs(_t(g) - np.asarray(j)).max() <= 2e-4


# -- (d) the chain -----------------------------------------------------------

def _port_node(i: int, **kw) -> Node:
    wl = tmt.ModelTrainingWorkload(device=CPU, **tmt.MICRO_KWARGS)
    return Node(node_id=i, classic_arg_bits=5, device=CPU,
                workloads={"model_train": wl}, **kw)


@pytest.fixture(scope="module")
def port_chain():
    store_ = ChainStore()
    net = Network.create(2, node_factory=lambda i: _port_node(
        i, **({"store": store_} if i == 0 else {})))
    for b in range(4):
        res = net.mine(b % 2, "model_train")
        assert not res.rejected_by, res.rejected_by
    return net, store_


def test_port_network_chain_trains_micro_blocks(port_chain):
    net, _ = port_chain
    assert net.converged()
    digests = {n.workloads["model_train"].state_digest() for n in net.nodes}
    assert len(digests) == 1
    assert len({tuple(sorted(n.book.balances.items()))
                for n in net.nodes}) == 1
    losses = [p.loss for p in net.nodes[0].chain_payloads()]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert [p.train_height for p in net.nodes[1].chain_payloads()] == \
        [0, 1, 2, 3]


def test_recover_and_reorg_give_equal_weights(port_chain):
    net, store_ = port_chain
    a, b = net.nodes
    rec = Node.recover(ChainStore.from_bytes(store_.to_bytes()),
                       node=_port_node(0))
    assert rec.last_recovery.adopted_height == a.ledger.height
    assert rec.ledger.tip_hash == a.ledger.tip_hash
    assert rec.workloads["model_train"].state_digest() == \
        a.workloads["model_train"].state_digest()
    assert rec.book.balances == a.book.balances
    rec.mine_block("model_train")          # private step 4
    r5 = b.mine_block("model_train")       # public step 4
    b.mine_block("classic")                # public chain wins on height
    assert rec.consider_chain(list(b.ledger.blocks), b.chain_payloads())
    assert rec.workloads["model_train"].round == r5.payload.train_height + 1
    assert rec.workloads["model_train"].state_digest() == \
        b.workloads["model_train"].state_digest()


def test_blocks_of_one_package_fail_the_others_replay_cleanly(port_chain):
    net, _ = port_chain
    port_block = net.nodes[0].chain_payloads()[0]
    jnode = JNode(node_id=0, classic_arg_bits=5, workloads={
        "model_train": jmt.ModelTrainingWorkload(**jmt.MICRO_KWARGS)})
    ref_block = jnode.mine_block("model_train").payload
    # the same program, the same batches; float training differs in the
    # last bits, so each replay disagrees with the other's digests
    assert ref_block.jash_id == port_block.jash_id
    assert np.array_equal(np.asarray(ref_block.micro_proof)[:, :32],
                          port_block.micro_proof[:, :32])
    twl = tmt.ModelTrainingWorkload(device=CPU, **tmt.MICRO_KWARGS)
    assert twl.verify(store.decode_payload(
        jstore.encode_payload(ref_block))) is False
    assert twl.is_pristine()
    jwl = jmt.ModelTrainingWorkload(**jmt.MICRO_KWARGS)
    assert jwl.verify(jstore.decode_payload(
        store.encode_payload(port_block))) is False
    assert jwl.is_pristine()
    # each package still takes its own block through the journal encoding
    assert twl.verify(store.decode_payload(store.encode_payload(port_block)))


def test_model_train_rejects_a_mesh():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmt.ModelTrainingWorkload(device=CPU, mesh=object())


def test_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_chain_train_model.py"),
         "--device", CPU], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert sum(ln.startswith("height ") for ln in lines) == 4
