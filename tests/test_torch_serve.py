"""The serving slice as a whole against the JAX package, on the CPU in
float32: the same converted weights and the same numpy prompt go through
both packages' prefill and decode, and the logits and greedy tokens must
agree. Also the configs, the bf16 weight conversion and the serve entry point.
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

from repro.configs import base as jbase  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
LOGIT_TOL = dict(rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", jbase.list_configs())
def test_configs_are_copies_of_the_reference(name):
    cfg, jcfg = base.get_config(name), jbase.get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(base.reduced(cfg)) == \
        dataclasses.asdict(jbase.reduced(jcfg))
    assert (cfg.resolved_head_dim, cfg.padded_vocab) == \
        (jcfg.resolved_head_dim, jcfg.padded_vocab)


def _slice_config(name):
    """(port config, reference config, prompt length) of a test model."""
    if name == "rwkv6-7b-reduced":
        cfg = base.reduced(base.get_config("rwkv6-7b"))
        assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.wkv_head_dim) == \
            ("ssm", 2, 256, 32)
        return cfg, jbase.reduced(jbase.get_config("rwkv6-7b")), 70
    if name == "recurrentgemma-2b-reduced-5":
        # 5 layers: one (rec, rec, attn) group and two rest layers; the
        # prompt is longer than the reduced window of 64, so the ring cache
        # rolls and the window masks
        cfg, jcfg = (dataclasses.replace(b.reduced(b.get_config(
            "recurrentgemma-2b")), n_layers=5) for b in (base, jbase))
        assert (cfg.family, cfg.window, cfg.n_heads, cfg.n_kv_heads) == \
            ("hybrid", 64, 8, 1)
        return cfg, jcfg, 70
    if name == "qwen3-0.6b-reduced":
        cfg = base.reduced(base.get_config("qwen3-0.6b"))
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads) == \
            (2, 256, 8, 8)
        return cfg, jbase.reduced(jbase.get_config("qwen3-0.6b")), 12
    cfg = base.get_config(name)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.qk_norm,
            cfg.tie_embeddings, cfg.dtype) == (8, 4, True, True, "float32")
    return cfg, jbase.get_config(name), 12


@pytest.mark.parametrize("name", ["qwen3-0.6b-reduced", "pnpcoin-demo",
                                  "rwkv6-7b-reduced",
                                  "recurrentgemma-2b-reduced-5"])
def test_prefill_and_decode_match_reference(name):
    cfg, jcfg, S = _slice_config(name)
    B, steps = 2, 8
    jmodel, model = jbuild(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    rs = np.random.RandomState(11)
    prompt = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rs.randint(0, cfg.vocab_size, (B, steps)).astype(np.int32)
    C = S + 2 * steps

    jprefill, jdecode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    jlog, jcache = jprefill(jparams, {"tokens": jnp.asarray(prompt)},
                            jmodel.init_cache(B, C))
    with torch.inference_mode():
        log, cache = model.prefill(params, {"tokens": torch.from_numpy(
            prompt)}, model.init_cache(B, C))
    assert log.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(log.numpy(), jlog, **LOGIT_TOL)

    # teacher-forced decode: the same token into both
    for t in range(steps):
        tok = forced[:, t:t + 1]
        jlog, jcache = jdecode(jparams, {"tokens": jnp.asarray(tok)}, jcache)
        with torch.inference_mode():
            log, cache = model.decode_step(
                params, {"tokens": torch.from_numpy(tok)}, cache)
        np.testing.assert_allclose(log.numpy(), jlog, **LOGIT_TOL,
                                   err_msg=f"forced step {t}")
    assert cache["pos"] == int(jcache["pos"]) == S + steps

    # greedy decode: each package feeds back its own argmax
    jtok = jnp.argmax(jlog[:, -1, :cfg.vocab_size], -1)[:, None]
    tok = torch.argmax(log[:, -1, :cfg.vocab_size], -1)[:, None]
    for t in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok),
                                      err_msg=f"greedy step {t}")
        jlog, jcache = jdecode(jparams, {"tokens": jtok.astype(jnp.int32)},
                               jcache)
        with torch.inference_mode():
            log, cache = model.decode_step(params, {"tokens": tok}, cache)
        jtok = jnp.argmax(jlog[:, -1, :cfg.vocab_size], -1)[:, None]
        tok = torch.argmax(log[:, -1, :cfg.vocab_size], -1)[:, None]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_bf16_params_convert_bit_for_bit():
    rs = np.random.RandomState(1)
    tree = {"w": jnp.asarray(rs.normal(size=(5, 7)), jnp.bfloat16),
            "sub": {"g": jnp.asarray(rs.normal(size=(3,)), jnp.float32),
                    "big": jnp.asarray([1e30, -0.0, 3.3e-39], jnp.bfloat16)}}
    got = params_from_jax(jax.tree.map(np.asarray, tree), device=CPU)
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (5, 7)
    assert got["sub"]["g"].dtype == torch.float32
    for t, j in ((got["w"], tree["w"]), (got["sub"]["big"],
                                         tree["sub"]["big"])):
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), np.asarray(j).view(np.int16))
    np.testing.assert_array_equal(got["sub"]["g"].numpy(), tree["sub"]["g"])


def test_serve_main_runs_on_cpu_and_prints_its_three_lines(capsys):
    res = serve.main(["--device", "cpu", "--reduced", "1", "--batch", "2",
                      "--prompt-len", "8", "--new-tokens", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "arch=qwen3-0.6b-smoke batch=2 prompt=8"
    assert lines[1].startswith("prefill: ") and "ms/tok" in lines[1]
    assert lines[2] == ("generated token ids (first row): "
                        f"{res.tokens[0].tolist()}")
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert int(res.tokens.max()) < 1024
    assert torch.isfinite(res.last_logits).all()


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_serve_main_runs_the_recurrent_archs_on_cpu(arch, capsys):
    res = serve.main(["--device", "cpu", "--arch", arch, "--reduced", "1",
                      "--batch", "2", "--prompt-len", "70",
                      "--new-tokens", "3"])
    assert capsys.readouterr().out.startswith(f"arch={arch}-smoke batch=2")
    assert res.tokens.shape == (2, 3) and int(res.tokens.max()) < 1024
    assert torch.isfinite(res.last_logits).all()


def test_serve_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "1", "--batch", "1", "--prompt-len", "4",
                    "--new-tokens", "2"])


def test_other_families_name_their_roadmap_item():
    # every family serves; training the others than dense (from a threefry
    # key, as the training driver inits) waits on its ROADMAP.md item
    cfg = dataclasses.replace(base.reduced(base.get_config("qwen3-0.6b")),
                              family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(cfg).init(random.key(0))


def test_serving_modules_import_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.models.rwkv6, repro_torch.models.rglru;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')];"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
