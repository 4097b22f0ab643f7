"""The moe, encdec and vlm families against the JAX package, on the CPU in
float32: the MoE router and dispatch, the cross-attention and the
sinusoidal positions, the stubbed encoders' inputs of the data pipeline,
and the reduced olmoe-1b-7b, arctic-480b, whisper-medium and
llama-3.2-vision-11b served from the reference's weights (converted by
``params_from_jax``) on the same numpy inputs. Also the plain flash
attention at head dim 80 (stablelm-3b), the serve entry point for each
config the slice adds, what the new families refuse (training), and
``remat``: the training forward recomputed layer by layer gives the same
bits.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.data.pipeline import SyntheticTokenPipeline as JPipe  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenPipeline  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, layers, moe  # noqa: E402
from repro_torch.models.model import build_model, supports_shape  # noqa: E402
from repro_torch.models.transformer import wants_grad  # noqa: E402

CPU = "cpu"
FAMILY_ARCHS = ["olmoe-1b-7b", "arctic-480b", "whisper-medium",
                "llama-3.2-vision-11b"]
NEW_ARCHS = FAMILY_ARCHS + ["qwen3-8b", "stablelm-1.6b", "stablelm-3b"]
LOGIT_TOL = dict(rtol=0, atol=1e-4)
# moe_ffn: both sum the expert products and the weighted combine in float32
# in other orders
MOE_TOL = dict(rtol=0, atol=1e-5)
AUX_TOL = dict(rtol=0, atol=1e-6)
# the port's random.normal against jax.random.normal (ROADMAP.md §3)
NORMAL_TOL = dict(rtol=0, atol=2e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(port config, reference model, port model, reference params, port
    params) of the reduced ``name``, the port's converted from the
    reference's. Both inits set a vlm's cross-layer gates to 0, where the
    image path adds nothing to the logits; here each gets a draw in
    [0.5, 1), so the comparisons hold that path too."""
    cfg = base.reduced(base.get_config(name))
    jcfg = jbase.reduced(jbase.get_config(name))
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    if cfg.family == "vlm":
        cross = jparams["groups"]["cross"]
        gate = np.random.RandomState(9).uniform(0.5, 1.0, cross["gate"].shape)
        jparams = {**jparams, "groups": {
            **jparams["groups"],
            "cross": {**cross, "gate": jnp.asarray(gate, jnp.float32)}}}
    return (cfg, jmodel, build_model(cfg), jparams,
            params_from_jax(_np(jparams), device=CPU))


@functools.lru_cache(maxsize=None)
def _jitted(jmodel):
    """The reference model's prefill and decode step, each jitted once."""
    return jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)


def _inputs(cfg, B, S, seed):
    """Tokens and, for vlm and encdec, the stubbed encoder's output."""
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rs.normal(
            size=(B, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32)
    if cfg.family == "encdec":
        batch["audio_frames"] = rs.normal(
            size=(B, cfg.n_enc_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# --------------------------------------------------------------------------
# MoE: router, dispatch, experts
# --------------------------------------------------------------------------


def _jax_slots(router, xt, top_k, E, C):
    """The reference's gate and dispatch (``repro/models/moe.py`` moe_ffn's
    own lines), to compare the port's slots and kept masks with."""
    probs = jax.nn.softmax(xt @ router, axis=-1)
    gate_w, gate_i = jax.lax.top_k(probs, top_k)
    flat_i = gate_i.reshape(-1)
    order = jnp.argsort(flat_i, stable=True)
    sorted_e = flat_i[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(E))
    ranks = jnp.arange(flat_i.shape[0]) - starts[sorted_e]
    pos = jnp.zeros(flat_i.shape, jnp.int32).at[order].set(
        ranks.astype(jnp.int32))
    keep = pos < C
    return gate_i, jnp.where(keep, flat_i * C + pos, E * C), keep


@pytest.mark.parametrize("name,cf", [("olmoe-1b-7b", None),
                                     ("arctic-480b", None),
                                     ("olmoe-1b-7b", 0.5)],
                         ids=["olmoe", "arctic", "olmoe-drops"])
def test_moe_ffn_matches_the_reference(name, cf):
    """Reduced olmoe (4 experts, top 2) and arctic at their drop-free
    capacity, then with a capacity factor of 0.5, which drops choices."""
    cfg = base.reduced(base.get_config(name))
    cf = cfg.capacity_factor if cf is None else cf
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    jp = jmoe.init_moe(jax.random.key(5), d, cfg.d_ff, E, jnp.float32)
    p = params_from_jax(_np(jp), device=CPU)
    x = np.random.RandomState(6).normal(size=(2, 24, d)).astype(np.float32)
    T = x.shape[0] * x.shape[1]
    C = max(1, math.ceil(T * k / E * cf))

    jgate, jslot, jkeep = _jax_slots(jp["router"],
                                     jnp.asarray(x.reshape(T, d)), k, E, C)
    _, _, gate_i = moe.route(p["router"], torch.from_numpy(x.reshape(T, d)),
                             k)
    slot, keep = moe.dispatch_slots(gate_i, E, C)
    np.testing.assert_array_equal(gate_i.numpy(), np.asarray(jgate))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert bool(keep.all()) == (cf == cfg.capacity_factor)

    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), top_k=k,
                              capacity_factor=cf)
    out, aux = moe.moe_ffn(p, torch.from_numpy(x), top_k=k,
                           capacity_factor=cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL)


def test_top_k_ties_go_to_the_lower_expert_as_in_jax():
    """Equal probabilities: jax.lax.top_k takes the lowest indices.
    torch.topk did not (on the CPU, torch 2.x, it gave experts 3 and 5 of
    6 equal ones), so the port ranks by a stable descending sort, which
    does."""
    xt = np.random.RandomState(2).normal(size=(5, 8)).astype(np.float32)
    router = np.zeros((8, 6), np.float32)
    _, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xt) @ router), 2)
    _, w, i = moe.route(torch.from_numpy(router), torch.from_numpy(xt), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), [[0, 1]] * 5)
    np.testing.assert_array_equal(w.numpy(), np.full((5, 2), 0.5, np.float32))


# --------------------------------------------------------------------------
# cross-attention, positions, the plain flash attention at hd 80
# --------------------------------------------------------------------------


@pytest.mark.parametrize("S,T", [(5, 11), (1, 11), (13, 4)])
def test_cross_attention_matches_the_reference(S, T):
    d, H, Kv, hd = 64, 4, 2, 16
    jp = jattn.init_attention(jax.random.key(3), d, H, Kv, hd, jnp.float32,
                              False)
    p = params_from_jax(_np(jp), device=CPU)
    rs = np.random.RandomState(S * 100 + T)
    x = rs.normal(size=(2, S, d)).astype(np.float32)
    src = rs.normal(size=(2, T, d)).astype(np.float32)
    jkv = jattn.cross_kv(jp, jnp.asarray(src), Kv, hd)
    kv = attention.cross_kv(p, torch.from_numpy(src), Kv, hd)
    for name in ("k", "v"):
        np.testing.assert_allclose(kv[name].numpy(), np.asarray(jkv[name]),
                                   rtol=0, atol=1e-5)
    want = jattn.cross_attention(jp, jnp.asarray(x), jkv, n_heads=H, n_kv=Kv,
                                 head_dim=hd)
    got = attention.cross_attention(p, torch.from_numpy(x), kv, n_heads=H,
                                    n_kv=Kv, head_dim=hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_sinusoidal_tables_equal_the_references():
    for n, d in ((37, 64), (1500, 1024)):
        np.testing.assert_array_equal(layers.sinusoidal_pos(n, d).numpy(),
                                      np.asarray(jlayers.sinusoidal_pos(n, d)))
    # the decode step's row, in float32 on both sides: each library's pow
    # rounds 10000^(2i/d) within an ulp, so the angle pos / 10000^(2i/d)
    # and its sine and cosine agree within ~pos 2^-23
    for pos in (0, 1, 17, 447):
        want = jlayers.sinusoidal_pos_at(jnp.int32(pos), 1024)
        np.testing.assert_allclose(layers.sinusoidal_pos_at(pos, 1024).numpy(),
                                   np.asarray(want), rtol=0,
                                   atol=1e-6 + pos * 2.0 ** -23)


@pytest.mark.parametrize("causal,S,T", [(True, 40, 40), (False, 40, 70),
                                        (False, 1, 33)])
def test_plain_flash_at_head_dim_80_matches_chunked_attention(causal, S, T):
    rs = np.random.RandomState(S + T)
    q = rs.normal(size=(2, S, 4, 80)).astype(np.float32)
    k, v = (rs.normal(size=(2, T, 2, 80)).astype(np.float32)
            for _ in range(2))
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# --------------------------------------------------------------------------
# the data pipeline's stubbed encoder inputs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,kind", [("llama-3.2-vision-11b", "prefill"),
                                       ("whisper-medium", "train"),
                                       ("whisper-medium", "decode")])
def test_pipeline_encoder_inputs_match_the_references(name, kind):
    cfg = base.reduced(base.get_config(name))
    jcfg = jbase.reduced(jbase.get_config(name))
    got = SyntheticTokenPipeline(cfg, InputShape("p", 16, 2, kind), 3) \
        .batch(1)
    want = JPipe(jcfg, JShape("p", 16, 2, kind), 3).batch(1)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        if key in ("image_embeds", "audio_frames"):
            assert got[key].dtype == torch.float32
            np.testing.assert_allclose(got[key].numpy(), np.asarray(val),
                                       **NORMAL_TOL)
        else:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(val))


# --------------------------------------------------------------------------
# the reduced models, whole
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_prefill_and_greedy_decode_match_the_reference(name):
    cfg, jmodel, model, jparams, params = _pair(name)
    B, S, steps = 2, 12, 8
    jbatch, batch = _inputs(cfg, B, S, seed=11)
    C = S + steps
    jprefill, jdecode = _jitted(jmodel)
    jlog, jcache = jprefill(jparams, jbatch, jmodel.init_cache(B, C))
    with torch.inference_mode():
        log, cache = model.prefill(params, batch, model.init_cache(B, C))
    assert log.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(log.numpy(), jlog, **LOGIT_TOL)

    for t in range(steps):
        jtok = jnp.argmax(jlog[:, -1, :cfg.vocab_size], -1)[:, None]
        tok = torch.argmax(log[:, -1, :cfg.vocab_size], -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok),
                                      err_msg=f"greedy step {t}")
        jlog, jcache = jdecode(jparams, {"tokens": jtok.astype(jnp.int32)},
                               jcache)
        with torch.inference_mode():
            log, cache = model.decode_step(params, {"tokens": tok}, cache)
        np.testing.assert_allclose(log.numpy(), jlog, **LOGIT_TOL,
                                   err_msg=f"decode step {t}")
    assert cache["pos"] == int(jcache["pos"]) == S + steps

    # the encoder's input reaches the logits in prefill and, through the
    # cached cross keys and values, at a decode step, in both packages: a
    # port that dropped it could not pass the comparisons above
    enc = {"vlm": "image_embeds", "encdec": "audio_frames"}.get(cfg.family)
    if enc is None:
        return
    jother, other = _inputs(cfg, B, S, seed=12)
    tok = batch["tokens"][:, -1:].clone()
    for pkg, run in (("reference", functools.partial(_jax_two_steps, jmodel,
                                                     jparams)),
                     ("port", functools.partial(_port_two_steps, model,
                                                params))):
        inputs = jbatch if pkg == "reference" else batch
        alt = {**inputs, enc: (jother if pkg == "reference" else other)[enc]}
        moved = [float(np.abs(a - b).max()) for a, b in
                 zip(run(inputs, tok, C), run(alt, tok, C))]
        assert min(moved) > 1e-2, (pkg, moved)


def _jax_two_steps(jmodel, jparams, jbatch, tok, C):
    """The reference's prefill logits and one decode step's after it."""
    jprefill, jdecode = _jitted(jmodel)
    log, cache = jprefill(jparams, jbatch, jmodel.init_cache(tok.shape[0], C))
    step, _ = jdecode(jparams, {"tokens": jnp.asarray(tok.numpy())}, cache)
    return np.asarray(log), np.asarray(step)


def _port_two_steps(model, params, batch, tok, C):
    """The port's prefill logits and one decode step's after it."""
    with torch.inference_mode():
        log, cache = model.prefill(params, batch,
                                   model.init_cache(tok.shape[0], C))
        step, _ = model.decode_step(params, {"tokens": tok}, cache)
    return log.numpy(), step.numpy()


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_teacher_forced_forward_matches_the_reference(name):
    cfg, jmodel, model, jparams, params = _pair(name)
    jbatch, batch = _inputs(cfg, 2, 16, seed=12)
    jlogits, jaux = jax.jit(jmodel.forward)(jparams, jbatch)
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    np.testing.assert_allclose(logits.numpy(), jlogits, **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL)
    assert (float(aux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_serve_main_runs_each_new_arch_on_cpu(name, capsys):
    res = serve.main(["--device", CPU, "--arch", name, "--reduced", "1",
                      "--batch", "2", "--prompt-len", "12",
                      "--new-tokens", "3"])
    assert capsys.readouterr().out.startswith(f"arch={name}-smoke batch=2")
    assert res.tokens.shape == (2, 3) and int(res.tokens.max()) < 1024
    assert torch.isfinite(res.last_logits).all()


def test_full_configs_shapes_and_support():
    cfg = base.get_config("stablelm-3b")
    assert (cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads) == (80, 32, 32)
    whisper = base.get_config("whisper-medium")
    assert (whisper.padded_vocab, whisper.rope_theta) == (51968, 0.0)
    long = InputShape("long_500k", 524_288, 1, "decode")
    assert supports_shape(whisper, long)[0] is False
    assert supports_shape(base.get_config("llama-3.2-vision-11b"), long)[0]


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_training_the_new_families_names_its_roadmap_item(name):
    cfg, _, model, _, params = _pair(name)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1, item 4"):
        model.init(random.key(0))
    _, batch = _inputs(cfg, 2, 8, seed=13)
    leaf = params["embed"].detach().requires_grad_(True)
    assert wants_grad({**params, "embed": leaf})
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1, item 4"):
        model.forward({**params, "embed": leaf}, batch)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------


def test_remat_gives_the_same_loss_and_gradients(monkeypatch):
    """A 2-layer qwen3-0.6b cut, its training forward with ``remat`` on and
    off: the loss and every gradient leaf bit-equal; with it on, each
    layer's attention runs twice (the forward, then the backward's
    recomputation)."""
    calls = []
    real = ops.flash_attention

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    cfg = base.reduced(base.get_config("qwen3-0.6b"))
    assert cfg.n_layers == 2
    params = build_model(cfg).init(torch.Generator().manual_seed(4))
    rs = np.random.RandomState(4)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 16))
                            .astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    out = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        leaves = {k: v for k, v in _leaves(params)}
        for v in leaves.values():
            v.requires_grad_(True)
        calls.clear()
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out[remat] = (loss.detach(), grads, len(calls))
        for v in leaves.values():
            v.requires_grad_(False)
    (l0, g0, n0), (l1, g1, n1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert (n0, n1) == (2, 4)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree
