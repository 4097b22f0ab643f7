"""The port's training entry point and bf16 training against the JAX
package, on the CPU.

(a) ``python -m repro_torch.launch.train`` and ``repro.launch.train`` on
``pnpcoin-demo`` with ``--reduced 1``, 3 blocks of batch 2 x 16 and a
checkpoint every 2 blocks: the printed losses agree within ``LOSS_TOL``,
the ledgers' jash ids, the checkpoint meta keys and the credits are equal,
and the port's ``ledger.json`` verifies. (b) The bf16 backward's plain
twin (``ref.flash_attention_bwd_ref``) on bf16 inputs against ``jax.grad``
of the reference's ``chunked_attention`` in bf16. (c) A bf16 cut of
qwen3-0.6b (``reduced`` at bf16, head dim 64) from the reference's initial
state: the loss and every gradient leaf of its first step, then 3 steps'
losses and each leaf's parameter change, each within the bf16 tolerances
below, which planted faults (a zeroed leaf, the tied embedding's lookup
gradient dropped, a step left out) exceed. (d) Which kernels
``FlashAttention`` would launch, and that it raises for what no instance
covers; ES noise drawn in passes equals each key's own draw.
"""

import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.data.pipeline import SyntheticTokenPipeline as JPipe  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import (ledger_from_json,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
# printed losses of the two drivers (float32, each from its own init)
LOSS_TOL = 1e-4
# bf16 against the reference. Both packages round their products and sums
# to bf16 at other places (a bf16 ulp is 2^-8 of a value), so the limits
# come from readings of sound runs on the cases below, each well under the
# faults that the cut's test plants:
# - an attention gradient: max |port - ref| <= BF16_GRAD_TOL max |ref| of
#   each tensor (readings 2.1e-3 to 8.5e-3);
# - a gradient leaf of the cut: ||port - ref|| <= BF16_LEAF_TOL ||ref||
#   (readings 1.0e-2 to 1.7e-2; a zeroed leaf gives 1, the tied
#   embedding's gradient without its lookup half 0.88);
# - a loss: |port - ref| <= BF16_LOSS_TOL |ref| (readings up to 1.8e-4);
# - a leaf's change over the 3 steps: ||port - ref|| <= BF16_UPDATE_TOL
#   ||ref|| (readings 2.1e-2 to 0.108, the params being bf16: an update
#   near a rounding edge moves a weight by an ulp or not; the change of 2
#   steps instead of 3 gives 0.37 to 0.40, no change at all 1)
BF16_GRAD_TOL = 2e-2
BF16_LEAF_TOL = 3e-2
BF16_LOSS_TOL = 1e-3
BF16_UPDATE_TOL = 0.2

_BLOCK = re.compile(r"block +(\d+) mode=(\w+) loss=([0-9.]+)")


def _run(main, argv, capsys):
    main(argv)
    out = capsys.readouterr().out
    return {int(h): float(loss) for h, _, loss in _BLOCK.findall(out)}, out


def test_train_main_matches_the_reference_driver(tmp_path, capsys):
    args = ["--arch", "pnpcoin-demo", "--reduced", "1", "--blocks", "3",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    jl, jout = _run(jtrain.main, args + ["--out", str(tmp_path / "ref")],
                    capsys)
    tl, tout = _run(ttrain.main, args + ["--out", str(tmp_path / "port"),
                                         "--device", CPU], capsys)
    assert sorted(tl) == sorted(jl) == [0, 2]
    for h in jl:
        assert abs(tl[h] - jl[h]) <= LOSS_TOL, (h, tl[h], jl[h])
    assert "chain verified." in tout and "chain verified." in jout
    port, refd = tmp_path / "port", tmp_path / "ref"
    ledger = ledger_from_json((port / "ledger.json").read_text())
    assert ledger.verify_chain() and ledger.height == 3
    jblocks = json.loads((refd / "ledger.json").read_text())
    assert [b.jash_id for b in ledger.blocks] == \
        [b["jash_id"] for b in jblocks]
    assert json.loads((port / "credits.json").read_text()) == \
        json.loads((refd / "credits.json").read_text())
    tmeta = json.loads((port / "ckpt_2.npz.meta.json").read_text())
    jmeta = json.loads((refd / "ckpt_2.npz.meta.json").read_text())
    assert sorted(tmeta) == sorted(jmeta) == ["block", "ledger_tip",
                                              "sha256"]
    assert tmeta["block"] == jmeta["block"] == 2
    assert tmeta["ledger_tip"] == ledger.blocks[1].block_hash


# (B, S, T, H, Kv, hd, causal, window): the bf16 backward's head dims, GQA
# and MQA, causal, windowed and S != T
BF16_TWIN_CASES = [(2, 24, 24, 4, 2, 64, True, 0),
                   (1, 33, 33, 2, 1, 128, True, 0),
                   (1, 20, 30, 4, 4, 64, False, 0),
                   (2, 40, 40, 8, 1, 64, True, 9)]


@pytest.mark.parametrize("case", BF16_TWIN_CASES)
def test_bf16_backward_twin_against_jax_grad(case):
    B, S, T, H, Kv, hd, causal, window = case
    rng = np.random.RandomState(sum(case))
    qn, kn, vn = (rng.randn(B, n, h, hd).astype(np.float32)
                  for n, h in ((S, H), (T, Kv), (T, Kv)))
    don = rng.randn(B, S, H, hd).astype(np.float32)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in (qn, kn, vn, don))
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                      window=window)

    def jloss(q, k, v):
        out = chunked_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out.astype(jnp.float32)
                       * jnp.asarray(don, jnp.bfloat16).astype(jnp.float32))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (qn, kn, vn))
    jgot = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    for g, j in zip(got, jgot):
        j32 = np.asarray(j.astype(jnp.float32))
        g16 = g.to(torch.bfloat16).float().numpy()
        assert g16.shape == j32.shape
        assert np.abs(g16 - j32).max() <= \
            BF16_GRAD_TOL * np.abs(j32).max()


def _bf16_cfg(jcfg):
    return dataclasses.replace(jreduced(jcfg), dtype="bfloat16",
                               head_dim=64, n_heads=4, n_kv_heads=2)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _unflatten_like(tree, leaves):
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _f32(x):
    """A leaf of either package as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _rel(got, want) -> float:
    """||got - want|| / ||want||, over the whole leaf."""
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _port_grads(model, params, batch, monkeypatch=None):
    """(loss, {path: gradient}) of the port's loss; with ``monkeypatch``,
    the tied embedding's lookup is cut from the graph (the fault its head
    half alone would be)."""
    flat = _paths(params)
    leaves = [p.detach().requires_grad_(True) for p in flat.values()]
    live = _unflatten_like(params, iter(leaves))
    if monkeypatch is not None:
        embedding = torch.nn.functional.embedding
        monkeypatch.setattr(torch.nn.functional, "embedding",
                            lambda t, w, *a, **k: embedding(t, w.detach(),
                                                            *a, **k))
    loss = model.loss(live, {k: torch.from_numpy(np.array(x))
                             for k, x in batch.items()})[0]
    if monkeypatch is not None:
        monkeypatch.undo()
    return loss, dict(zip(flat, torch.autograd.grad(loss, leaves)))


def test_bf16_qwen3_cut_trains_as_the_reference(monkeypatch):
    jcfg = _bf16_cfg(jget_config("qwen3-0.6b"))
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jstate = jsteps.make_train_state(jcfg, jax.random.key(0))
    tstate = train_state_from_jax(jstate.params, jstate.opt.step,
                                  jstate.opt.m, jstate.opt.v, device=CPU)
    assert tstate.params["embed"].dtype == torch.bfloat16
    assert tstate.opt.m["embed"].dtype == torch.float32
    pipe = JPipe(jcfg, JInputShape("t", 16, 2, "train"), seed=0)
    batches = [pipe.batch(i) for i in range(3)]

    # the first step's loss and gradients, leaf by leaf on its own scale
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, batches[0])[0])(jstate.params)
    t0 = _paths(tstate.params)
    tloss, tgrads = _port_grads(tmodel, tstate.params, batches[0])
    assert abs(tloss.item() - float(jloss)) <= BF16_LOSS_TOL * abs(
        float(jloss))
    jg = {path: _f32(g) for path, g in _paths(jgrads).items()}
    assert sorted(jg) == sorted(tgrads)
    for path, g in tgrads.items():
        assert g.dtype == t0[path].dtype, path
        assert _rel(_f32(g), jg[path]) <= BF16_LEAF_TOL, path
    # the same limit rejects a zeroed leaf and the tied embedding's
    # gradient without its lookup half
    for path in jg:
        assert _rel(np.zeros_like(jg[path]), jg[path]) > BF16_LEAF_TOL
    _, head_only = _port_grads(tmodel, tstate.params, batches[0],
                               monkeypatch)
    assert _rel(_f32(head_only["/embed"]), jg["/embed"]) > BF16_LEAF_TOL

    # three steps: the losses, then each leaf's change
    hp = dict(warmup_steps=2, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsteps.TrainHparams(**hp)))
    tstep = tsteps.make_train_step(tcfg, tsteps.TrainHparams(**hp))
    j0 = _paths(jstate.params)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(np.array(x))
                                    for k, x in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            BF16_LOSS_TOL * abs(float(jm["loss"])), i
        if i == 1:
            t2 = _paths(tstate.params)
    j3, t3 = _paths(jstate.params), _paths(tstate.params)
    for path in j0:
        want = _f32(j3[path]) - _f32(j0[path])
        assert _rel(_f32(t3[path]) - _f32(t0[path]), want) <= \
            BF16_UPDATE_TOL, path
        # and rejects a step left out
        assert _rel(_f32(t2[path]) - _f32(t0[path]), want) > \
            BF16_UPDATE_TOL, path
    # params stay in their dtypes after the float32 update, m and v float32
    for path, leaf in t3.items():
        assert str(leaf.dtype).split(".")[1] == str(j3[path].dtype), path
    assert {leaf.dtype for leaf in tree_leaves(tstate.opt.m)} == \
        {torch.float32}
    assert int(tstate.opt.step) == 3


def test_normal_concat_passes_change_no_bit(monkeypatch):
    """ES noise drawn in passes of at most ``random.PIECE`` elements (whole
    draws grouped, long draws split) equals each key's own draw."""
    from repro_torch import random
    keys = random.split(random.key(3), 5)
    sizes = [10, 0, 37, 5, 1 << 10]
    want = torch.cat([random.normal(keys[i], (n,))
                      for i, n in enumerate(sizes)])
    for piece in (1 << 24, 16, 7):
        monkeypatch.setattr(random, "PIECE", piece)
        assert torch.equal(random.normal_concat(keys, sizes), want)
    assert random.normal_concat(keys[:2], [0, 0]).shape == (0,)


def test_flash_attention_training_kernels_by_dtype_and_head_dim():
    for hd in (16, 32, 64, 128):
        assert fa.train_kernels_for(torch.float32, hd) == "cuda_core"
    for hd in (64, 128, 256):
        assert fa.train_kernels_for(torch.bfloat16, hd) == "tensor_core"
    for dtype, hd in ((torch.bfloat16, 32), (torch.bfloat16, 80),
                      (torch.float16, 128), (torch.float32, 256)):
        with pytest.raises(TypeError, match="no training instance"):
            fa.train_kernels_for(dtype, hd)
