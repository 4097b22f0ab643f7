"""The port's checkpoints (``repro_torch/train/checkpoint.py``) against the
JAX package's (``repro/train/checkpoint.py``), on the CPU.

A state carried across by ``convert.train_state_from_jax`` saves to the
reference's bytes: the float32 ``pnpcoin-demo`` state as it stands after
two reference train steps (so m, v and the step are not zeros), and a small
bfloat16 state (reduced ``qwen3-0.6b`` at bf16 with float32 moments), whose
bf16 leaves both packages store as ``'<V2'``. The port loads a file the
reference wrote, bf16 leaves included (the reference itself cannot: its
load casts from a void type, ROADMAP.md §3), to the same ``state_digest``;
the reference loads the port's float32 file.
"""

import dataclasses
import io
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.data.pipeline import SyntheticTokenPipeline as JPipe  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"


def _jax_state(cfg, steps: int):
    """The reference's TrainState from its own init, after ``steps`` train
    steps on the synthetic pipeline (batch 2 of 16 tokens)."""
    state = jsteps.make_train_state(cfg, jax.random.key(0))
    if steps:
        pipe = JPipe(cfg, JInputShape("t", 16, 2, "train"), seed=0)
        step = jax.jit(jsteps.make_train_step(
            cfg, jsteps.TrainHparams(warmup_steps=2, total_steps=10)))
        for i in range(steps):
            state, _ = step(state, pipe.batch(i))
    return state


def _carry(state):
    return train_state_from_jax(state.params, state.opt.step, state.opt.m,
                                state.opt.v, device=CPU)


def _bf16_cfg():
    return dataclasses.replace(jreduced(jget_config("qwen3-0.6b")),
                               dtype="bfloat16", head_dim=64, n_heads=4,
                               n_kv_heads=2)


@pytest.fixture(scope="module")
def states():
    demo = _jax_state(jget_config("pnpcoin-demo"), 2)
    small = _jax_state(_bf16_cfg(), 0)
    return {"pnpcoin-demo": demo, "bf16": small}


@pytest.mark.parametrize("which", ["pnpcoin-demo", "bf16"])
def test_port_checkpoint_is_the_reference_bytes(states, which, tmp_path):
    ref = states[which]
    meta = {"block": 3, "ledger_tip": "ab" * 32}
    want = jckpt.save_checkpoint(str(tmp_path / "ref.npz"), ref, meta)
    got = tckpt.save_checkpoint(str(tmp_path / "port.npz"), _carry(ref),
                                meta)
    assert got == want
    assert (tmp_path / "port.npz").read_bytes() == \
        (tmp_path / "ref.npz").read_bytes()
    assert (tmp_path / "port.npz.meta.json").read_text() == \
        (tmp_path / "ref.npz.meta.json").read_text()
    assert tckpt.state_digest(_carry(ref)) == jckpt.state_digest(ref)
    keys = np.load(io.BytesIO((tmp_path / "port.npz").read_bytes())).files
    assert keys[0] == ".params/embed"
    assert ".opt/.step" in keys and ".opt/.m/embed" in keys


def test_params_digest_of_bf16_params_is_the_references(states):
    """The chain's state digest frames a bf16 leaf as the reference does
    (its dtype string ``'<V2'``, its bits)."""
    ref = states["bf16"]
    assert tsteps.params_digest(_carry(ref)) == jsteps.params_digest(ref)


def test_bf16_leaves_are_stored_as_void_and_load_by_their_bits(states,
                                                               tmp_path):
    ref = states["bf16"]
    path = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(path, ref)
    with zipfile.ZipFile(path) as zf:
        assert b"'descr': '<V2'" in zf.read(".params/embed.npy")[:128]
    with np.load(path) as npz:
        assert npz[".params/embed"].dtype.itemsize == 2
        assert npz[".opt/.m/embed"].dtype == np.float32
    like = _carry(ref)
    assert like.params["embed"].dtype == torch.bfloat16
    # the reference cannot reload its own bf16 file
    with pytest.raises(ValueError):
        jckpt.load_checkpoint(path, ref)
    loaded, digest = tckpt.load_checkpoint(path, like)
    assert digest == tckpt.file_digest(path)
    assert tckpt.state_digest(loaded) == jckpt.state_digest(ref)
    assert torch.equal(loaded.params["embed"].view(torch.int16),
                       like.params["embed"].view(torch.int16))


def test_port_loads_reference_float32_file_and_back(states, tmp_path):
    ref = states["pnpcoin-demo"]
    ref_path = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(ref_path, ref)
    zeros = jax.tree_util.tree_map(lambda x: x * 0, ref)
    loaded, _ = tckpt.load_checkpoint(ref_path, _carry(zeros))
    assert tckpt.state_digest(loaded) == jckpt.state_digest(ref)
    assert int(loaded.opt.step) == 2
    port_path = str(tmp_path / "port.npz")
    digest = tckpt.save_checkpoint(port_path, loaded)
    back, ref_digest = jckpt.load_checkpoint(port_path, zeros)
    assert ref_digest == digest
    assert jckpt.state_digest(back) == jckpt.state_digest(ref)
