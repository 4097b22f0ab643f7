"""Training the recurrent families in the port against the JAX package, on
the CPU.

(a) The plain backwards the card's kernels are held to
(``ref.decay_scan_bwd_ref``, ``ref.wkv6_bwd_ref``) against ``jax.vjp`` of
the reference's recurrences, with and without a final-state gradient, and
autograd through the port's CPU ``ops`` path against both. (b) The
threefry init of reduced recurrentgemma-2b (hybrid) and reduced rwkv6-7b
(ssm) against the reference's ``init(jax.random.key(0))``, leaf by leaf.
(c) The loss and every gradient leaf of both reduced models against
``jax.grad`` of the reference's ``Model.loss``; ``remat`` on and off give
the same bits. (d) ``launch.train.main`` of both packages on both archs.
Inputs are made from a numpy seed.
"""

import dataclasses
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
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

CPU = "cpu"
ARCHS = ["recurrentgemma-2b", "rwkv6-7b"]
# the plain backwards against jax.vjp: max |port - ref| of each tensor
# within this share of the tensor's largest entry (both are float32 loops
# or scans; readings up to 2e-7)
BWD_TOL = 1e-5
# a threefry normal draw (repro_torch.random.normal's stated bound)
NORMAL_TOL = 4.8e-7
# lambda, from no key: the reference's XLA rounds its float32 linspace and
# log differently from PyTorch by a few ulps, which exp(x) - 1 near
# x = 0.013 amplifies (reading 9.2e-6 of the leaf's largest entry)
LAMBDA_TOL = 1e-4
# a gradient leaf of a reduced float32 model: ||port - ref|| / ||ref||.
# Both packages differentiate float32 graphs that sum in other orders (the
# reference scans its recurrences with associative_scan and lax.scan, the
# port's CPU path a doubling scan and chunks of 16 steps); readings up to
# 3.1e-6 (recurrentgemma) and 3.8e-5 (rwkv's u, a sum over every step and
# batch row of terms of both signs)
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
# printed losses of the two drivers (float32, each from its own init)
DRIVER_LOSS_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _f(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _scaled_err(got, want) -> float:
    """max |got - want| over want's largest entry (an all-zero want must be
    met exactly)."""
    want = _f(want)
    return float(np.abs(_f(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


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


# --------------------------------------------------------------------------
# (a) the plain backwards
# --------------------------------------------------------------------------

# (B, S, C): odd shapes, S = 1 and a single channel
DECAY_CASES = [(2, 37, 24), (1, 1, 5), (3, 16, 1)]


def _decay_inputs(B, S, C, seed=0):
    rs = np.random.RandomState(seed + B * 1000 + S * 10 + C)
    return [rs.uniform(0.3, 1.0, (B, S, C)).astype(np.float32),
            rs.normal(size=(B, S, C)).astype(np.float32),
            rs.normal(size=(B, C)).astype(np.float32),
            rs.normal(size=(B, S, C)).astype(np.float32),
            rs.normal(size=(B, C)).astype(np.float32)]


def _jax_decay_vjp(a, b, h0, dh, dh_last):
    """jax.vjp of the reference's decay scan and its last state."""
    def f(a, b):
        h = jref.decay_scan_ref(a, b, h0)
        return h, h[:, -1]
    _, vjp = jax.vjp(f, a, b)
    return vjp((dh, dh_last if dh_last is not None else jnp.zeros_like(
        dh[:, 0])))


@pytest.mark.parametrize("case", DECAY_CASES)
@pytest.mark.parametrize("final", [True, False])
def test_decay_scan_bwd_twin_equals_jax_vjp(case, final):
    a, b, h0, dh, dl = _decay_inputs(*case)
    dl = dl if final else None
    want_da, want_db = _jax_decay_vjp(a, b, h0, dh, dl)
    h = ref.decay_scan_ref(_t(a), _t(b), _t(h0))
    da, db, _ = ref.decay_scan_bwd_ref(_t(a), h, _t(dh),
                                       None if dl is None else _t(dl),
                                       _t(h0))
    assert _scaled_err(da, want_da) <= BWD_TOL
    assert _scaled_err(db, want_db) <= BWD_TOL


@pytest.mark.parametrize("case", DECAY_CASES)
def test_decay_scan_autograd_on_the_cpu_equals_jax_and_the_twin(case):
    a, b, h0, dh, dl = _decay_inputs(*case, seed=1)
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    h, h_last = ops.decay_scan(ta, tb)
    da, db = torch.autograd.grad((h * _t(dh)).sum()
                                 + (h_last * _t(dl)).sum(), (ta, tb))
    want_da, want_db = _jax_decay_vjp(a, b, None, dh, dl)
    assert _scaled_err(da, want_da) <= BWD_TOL
    assert _scaled_err(db, want_db) <= BWD_TOL
    twin = ref.decay_scan_bwd_ref(ta.detach(), h.detach(), _t(dh), _t(dl))
    assert _scaled_err(da, twin[0]) <= BWD_TOL
    assert _scaled_err(db, twin[1]) <= BWD_TOL


# (B, S, H, K, V): odd lengths, S = 1, K != V
WKV_CASES = [(2, 37, 2, 32, 32), (1, 1, 3, 8, 8), (2, 9, 1, 5, 7)]


def _wkv_inputs(B, S, H, K, V, seed=0):
    rs = np.random.RandomState(seed + B + 3 * S + 7 * H + 11 * K + V)
    return [rs.normal(size=(B, S, H, K)).astype(np.float32),
            rs.normal(size=(B, S, H, K)).astype(np.float32),
            rs.normal(size=(B, S, H, V)).astype(np.float32),
            rs.uniform(0.4, 0.99, (B, S, H, K)).astype(np.float32),
            rs.normal(size=(H, K)).astype(np.float32),
            rs.normal(size=(B, S, H, V)).astype(np.float32),
            rs.normal(size=(B, H, K, V)).astype(np.float32)]


def _jax_wkv_vjp(r, k, v, w, u, do, ds_final):
    B, _, H, K = r.shape
    s0 = jnp.zeros((B, H, K, v.shape[-1]), jnp.float32)
    _, vjp = jax.vjp(lambda *x: jrwkv.wkv_ref(*x, s0), r, k, v, w, u)
    return vjp((do, ds_final if ds_final is not None
                else jnp.zeros_like(s0)))


@pytest.mark.parametrize("case", WKV_CASES)
@pytest.mark.parametrize("final", [True, False])
def test_wkv6_bwd_twin_equals_jax_vjp(case, final):
    r, k, v, w, u, do, dsf = _wkv_inputs(*case)
    dsf = dsf if final else None
    want = _jax_wkv_vjp(r, k, v, w, u, do, dsf)
    got = ref.wkv6_bwd_ref(*map(_t, (r, k, v, w, u, do)),
                           None if dsf is None else _t(dsf))
    for name, g, wnt in zip("r k v w u".split(), got, want):
        assert g.shape == wnt.shape, name
        assert _scaled_err(g, wnt) <= BWD_TOL, name


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_autograd_on_the_cpu_equals_jax_and_the_twin(case):
    r, k, v, w, u, do, dsf = _wkv_inputs(*case, seed=2)
    leaves = [_t(x).requires_grad_(True) for x in (r, k, v, w, u)]
    out, s_final = ops.wkv6(*leaves)
    got = torch.autograd.grad((out * _t(do)).sum()
                              + (s_final * _t(dsf)).sum(), leaves)
    want = _jax_wkv_vjp(r, k, v, w, u, do, dsf)
    twin = ref.wkv6_bwd_ref(*(x.detach() for x in leaves), _t(do), _t(dsf))
    for name, g, wnt, tw in zip("r k v w u".split(), got, want, twin):
        assert _scaled_err(g, wnt) <= BWD_TOL, name
        assert _scaled_err(g, tw) <= BWD_TOL, name


def test_a_start_state_that_requires_grad_raises():
    a, b, h0, _, _ = _decay_inputs(1, 4, 3)
    with pytest.raises(NotImplementedError, match="h0 requires grad"):
        ops.decay_scan(_t(a), _t(b), _t(h0).requires_grad_(True))
    # a later piece's start is the piece before's h_last
    with pytest.raises(NotImplementedError, match="h0"):
        ops.decay_scan(_t(a).requires_grad_(True), _t(b), seq_chunk=2)
    r, k, v, w, u, _, s0 = _wkv_inputs(1, 3, 1, 4, 4)
    with pytest.raises(NotImplementedError, match="s0 requires grad"):
        ops.wkv6(*map(_t, (r, k, v, w, u)), _t(s0).requires_grad_(True))
    # without grad mode, a start state is an input like any other
    with torch.no_grad():
        ops.wkv6(*map(_t, (r, k, v, w, u)), _t(s0).requires_grad_(True))


# --------------------------------------------------------------------------
# (b) threefry init, (c) loss and gradients
# --------------------------------------------------------------------------


def _cfgs(arch):
    jcfg = jreduced(jget_config(arch))
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_key_init_draws_the_references_weights(arch):
    jcfg, tcfg = _cfgs(arch)
    want = _paths(jbuild(jcfg).init(jax.random.key(0)))
    got = _paths(build_model(tcfg).init(trandom.key(0)))
    assert sorted(got) == sorted(want)
    normal = 0
    for path, leaf in want.items():
        leaf = np.asarray(leaf)
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[1] == str(leaf.dtype), path
        if path.endswith("/lambda"):
            assert _scaled_err(got[path], leaf) <= LAMBDA_TOL, path
        elif np.unique(leaf).size > 1:      # a normal draw
            assert np.abs(_f(got[path]) - leaf).max() <= NORMAL_TOL, path
            normal += 1
        else:                               # a constant
            assert np.array_equal(_f(got[path]), leaf), path
    assert normal >= (6 if arch == "rwkv6-7b" else 10)


def _loss_and_grads(model, params, batch):
    flat = _paths(params)
    leaves = [p.detach().clone().requires_grad_(True) for p in flat.values()]
    live = _unflatten_like(params, iter(leaves))
    loss = model.loss(live, {k: _t(x) for k, x in batch.items()})[0]
    return loss, dict(zip(flat, torch.autograd.grad(loss, leaves)))


@pytest.fixture(scope="module", params=ARCHS)
def grad_case(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jbuild(jcfg).init(jax.random.key(0))
    batch = JPipe(jcfg, JInputShape("t", 24, 2, "train"), seed=0).batch(0)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jbuild(jcfg).loss(p, batch)[0])(jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    return dict(tcfg=tcfg, params=params, batch=batch, jloss=float(jloss),
                jgrads={p: np.asarray(g) for p, g in _paths(jgrads).items()})


def test_loss_and_every_gradient_leaf_equal_jax_grad(grad_case):
    loss, grads = _loss_and_grads(build_model(grad_case["tcfg"]),
                                  grad_case["params"], grad_case["batch"])
    assert abs(loss.item() - grad_case["jloss"]) <= \
        LOSS_TOL * abs(grad_case["jloss"])
    jg = grad_case["jgrads"]
    assert sorted(grads) == sorted(jg)
    for path, g in grads.items():
        assert np.linalg.norm(jg[path]) > 0, path
        err = np.linalg.norm(_f(g) - jg[path]) / np.linalg.norm(jg[path])
        assert err <= GRAD_TOL, (path, err)


def test_remat_gives_the_same_bits(grad_case):
    cfg = grad_case["tcfg"]
    out = [_loss_and_grads(build_model(dataclasses.replace(cfg, remat=on)),
                           grad_case["params"], grad_case["batch"])
           for on in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for path, g in out[0][1].items():
        assert torch.equal(g, out[1][1][path]), path


# --------------------------------------------------------------------------
# (d) the training driver
# --------------------------------------------------------------------------

_BLOCK = re.compile(r"block +(\d+) mode=(\w+) loss=([0-9.]+)")


def _run(main, argv, capsys):
    main(argv)
    out = capsys.readouterr().out
    return {int(h): float(loss) for h, _, loss in _BLOCK.findall(out)}, out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_matches_the_reference_driver(arch, tmp_path, capsys):
    import json
    args = ["--arch", arch, "--reduced", "1", "--blocks", "2", "--batch",
            "2", "--seq", "16", "--ckpt-every", "2"]
    jl, jout = _run(jtrain.main, args + ["--out", str(tmp_path / "ref")],
                    capsys)
    tl, tout = _run(ttrain.main, args + ["--out", str(tmp_path / "port"),
                                         "--device", CPU], capsys)
    assert sorted(tl) == sorted(jl) == [0, 1]
    for h in jl:
        assert abs(tl[h] - jl[h]) <= DRIVER_LOSS_TOL, (h, tl[h], jl[h])
    assert "chain verified." in tout and "chain verified." in jout
    port, refd = tmp_path / "port", tmp_path / "ref"
    jblocks = json.loads((refd / "ledger.json").read_text())
    tblocks = json.loads((port / "ledger.json").read_text())
    assert [b["jash_id"] for b in tblocks] == [b["jash_id"] for b in jblocks]
    assert json.loads((port / "credits.json").read_text()) == \
        json.loads((refd / "credits.json").read_text())
    tmeta = json.loads((port / "ckpt_2.npz.meta.json").read_text())
    jmeta = json.loads((refd / "ckpt_2.npz.meta.json").read_text())
    assert sorted(tmeta) == sorted(jmeta)
    assert tmeta["block"] == jmeta["block"] == 2


# (B, S, C) and (B, S, H, K, V): S = 1, S past a doubling step or a chunk
FORM_CASES = [((2, 1, 3), (1, 1, 2, 4, 4)), ((2, 37, 24), (2, 37, 2, 8, 6)),
              ((1, 64, 9), (1, 33, 1, 16, 16))]


@pytest.mark.parametrize("decay_case,wkv_case", FORM_CASES)
def test_both_cpu_forms_equal_the_reference(decay_case, wkv_case):
    """The sequential loops (the card's twins) and the few-op forms the CPU
    path runs, against the reference's recurrences; a decay that underflows
    to 0 stays finite in the chunked form."""
    a, b, h0, _, _ = _decay_inputs(*decay_case, seed=3)
    want = np.asarray(jref.decay_scan_ref(*map(jnp.asarray, (a, b, h0))))
    for form in (ref.decay_scan_ref, ref.decay_scan_doubling):
        assert _scaled_err(form(_t(a), _t(b), _t(h0)), want) <= BWD_TOL
    r, k, v, w, u, _, s0 = _wkv_inputs(*wkv_case, seed=3)
    w[:, :1] = 0.0
    want_o, want_s = jrwkv.wkv_ref(r, k, v, w, u, s0)
    for form in (ref.wkv6_ref, ref.wkv6_chunked):
        o, s = form(*map(_t, (r, k, v, w, u, s0)))
        assert _scaled_err(o, want_o) <= BWD_TOL, form.__name__
        assert _scaled_err(s, want_s) <= BWD_TOL, form.__name__
