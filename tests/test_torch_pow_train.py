"""Proof-of-useful-work training on the port against the JAX package, on the
CPU: ``core/es.py``, ``core/pow_train.py`` and ``TrainingWorkload``.

(a) The step jash's id, the pipeline's batches and its checksum equal the
reference's. (b) ES: the leaf order, ``candidate_params``, ``es_block``
and ``es_update`` on the same params and keys. (c) ``PoUWTrainer`` from
the reference's initial params: full-mode losses over 3 blocks and the
first optimal block. All at ``pnpcoin-micro``'s size, ES with 8
candidates. (d), the port's training chain within itself, is
``tests/test_torch_training_chain.py``.

``repro_torch.random.normal`` is within ``NORMAL_TOL`` of
``jax.random.normal``, not bit-exact (its ``erf_inv`` takes ``log1p``,
which the two libraries round differently in ~1% of the draws), so ES
candidates differ from the reference's by at most sigma times that.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.chain.workloads import model_train as jmt  # noqa: E402
from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.core import es as jes  # noqa: E402
from repro.core.pow_train import PoUWTrainer as JTrainer  # noqa: E402
from repro.data.pipeline import SyntheticTokenPipeline as JPipe  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.chain.workloads import model_train as tmt  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import es  # noqa: E402
from repro_torch.core.jash import Jash  # noqa: E402
from repro_torch.core.pow_train import PoUWTrainer  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenPipeline  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
SHAPE = (16, 2)                 # seq, batch: MICRO_KWARGS' shape
HP = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)
ES = dict(pop_size=8, sigma=0.02)
# |repro_torch.random.normal - jax.random.normal| (tests/test_torch_train.py)
NORMAL_TOL = 2e-6
# ES losses and the ES gradient step against the reference's
ES_TOL = 1e-5
# full-mode losses over 3 blocks against the reference's
FULL_TOL = 1e-4


def _t(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _tleaves(tree):
    return [_t(x) for x in tadamw.tree_leaves(tree)]


def _trainers(mode: str, **kw):
    """The reference's trainer and the port's, the port's state replaced by
    the reference's initial params (converted) and fresh AdamW state; and
    those initial params."""
    cfg = tmt.MICRO_CONFIG
    jt = JTrainer(jmt.MICRO_CONFIG, JInputShape("t", *SHAPE, "train"),
                  hp=jsteps.TrainHparams(**HP), mode=mode, n_miners=4, **kw)
    tt = PoUWTrainer(cfg, InputShape("t", *SHAPE, "train"),
                     hp=tsteps.TrainHparams(**HP), mode=mode, n_miners=4,
                     device=CPU, **kw)
    init = jax.tree.map(np.asarray, jt.state.params)
    params = params_from_jax(init, device=CPU)
    tt.state = tsteps.TrainState(params, tadamw.adamw_init(
        params, getattr(torch, cfg.opt_dtype)))
    return jt, tt, init


@pytest.fixture(scope="module")
def full_pair():
    jt, tt, _ = _trainers("full")
    return jt, tt, jt.run(3), tt.run(3)


@pytest.fixture(scope="module")
def optimal_pair():
    jt, tt, init = _trainers("optimal", **ES)
    return jt, tt, jt.run_block(), tt.run_block(), init


# -- (a) integers ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "optimal"])
def test_step_jash_id_equals_the_references(mode, full_pair, optimal_pair):
    jt, tt = (full_pair if mode == "full" else optimal_pair)[:2]
    assert tt.step_jash.source_id() == jt.step_jash.source_id()
    assert tt.ledger.blocks[0].jash_id == jt.ledger.blocks[0].jash_id


def test_pipeline_batches_and_checksum_equal_the_references(full_pair):
    jt, tt = full_pair[:2]
    assert tt.pipeline.checksum() == jt.pipeline.checksum()
    for step in range(3):
        jb, tb = jt.pipeline.batch(step), tt.pipeline.batch(step)
        for key in ("tokens", "labels"):
            assert np.array_equal(np.asarray(jb[key]), _t(tb[key]))


def test_step_review_exports_both_halves_of_the_step(full_pair):
    """The review (ROADMAP.md §3): the loss's forward and the update, each
    exported and walked; the whole step does not export."""
    tt = full_pair[1]
    loss, update = tt.step_jash.validate(tt.state, tt.pipeline.batch(0))
    assert {"aten.embedding.default", "aten.logsumexp.default"} <= \
        {str(n.target) for n in loss.graph.nodes}
    assert "aten.sqrt.default" in {str(n.target) for n in update.graph.nodes}
    whole = Jash("whole", tt.step_jash.fn, tt.step_jash.meta)
    with pytest.raises(RuntimeError, match="fake tensor"):
        whole.validate(tt.state, tt.pipeline.batch(0))


# -- (b) ES -------------------------------------------------------------------

def test_leaf_order_is_jax_tree_flatten_order():
    tree = {"b": np.float32([1, 2]), "a": {"z": np.float32([3]),
                                           "c": np.float32([[4, 5]])},
            "A": np.float32([6])}
    jtree = jax.tree.map(jax.numpy.asarray, tree)
    ttree = params_from_jax(tree, device=CPU)
    assert [x.tolist() for x in _jleaves(jtree)] == \
        [x.tolist() for x in _tleaves(ttree)]
    # each leaf draws from its own subkey: another order moves the noise
    jp = jes.perturb(jtree, jax.random.key(5), 1.0)
    tp = es.perturb(ttree, trandom.key(5), 1.0)
    for want, got in zip(_jleaves(jp), _tleaves(tp)):
        assert np.abs(got - want).max() <= NORMAL_TOL


@pytest.fixture(scope="module")
def micro_params():
    state = jsteps.make_train_state(jmt.MICRO_CONFIG, jax.random.key(0))
    params = jax.tree.map(np.asarray, state.params)
    # signed zeros, where candidate 0's "+ -0.0 * noise" shows
    params["ln_f"] = np.where(np.arange(params["ln_f"].size) % 2, -0.0,
                              0.0).astype(np.float32)
    return params


@pytest.mark.parametrize("i", range(5))
def test_candidate_params_equal_the_references(micro_params, i):
    """Bit for bit where the two ``normal``s agree (all but ~1% of the
    draws, and every draw of candidate 0, whose noise is scaled by -0.0);
    elsewhere within sigma NORMAL_TOL plus one rounding of the sum."""
    sigma = 0.02
    jc = jes.candidate_params(jax.tree.map(jax.numpy.asarray, micro_params),
                              jax.random.key(11), i, sigma)
    tc = es.candidate_params(params_from_jax(micro_params, device=CPU),
                             trandom.key(11), i, sigma)
    differ = total = 0
    for want, got in zip(_jleaves(jc), _tleaves(tc)):
        assert got.dtype == want.dtype and got.shape == want.shape
        tol = sigma * NORMAL_TOL + np.spacing(np.abs(want).max())
        assert np.abs(got - want).max() <= tol
        differ += int((got.view(np.int32) != want.view(np.int32)).sum())
        total += want.size
    if i == 0:
        assert differ == 0
    assert differ <= 0.05 * total, (differ, total)


def test_es_block_and_update_within_their_tolerance(micro_params):
    cfg, jcfg = tmt.MICRO_CONFIG, jmt.MICRO_CONFIG
    jb = JPipe(jcfg, JInputShape("t", *SHAPE, "train")).batch(0)
    tb = SyntheticTokenPipeline(cfg, InputShape("t", *SHAPE, "train")).batch(0)
    jparams = jax.tree.map(jax.numpy.asarray, micro_params)
    tparams = params_from_jax(micro_params, device=CPU)
    jl, jbest = jes.es_block(jsteps.make_eval_step(jcfg), jparams, jb,
                             jax.random.key(4), **ES)
    tl, tbest = es.es_block(tsteps.make_eval_step(cfg), tparams, tb,
                            trandom.key(4), **ES)
    assert tl.shape == (ES["pop_size"],)
    assert np.abs(_t(tl) - np.asarray(jl)).max() <= ES_TOL
    assert int(tbest) == int(jbest)
    # the same losses into both updates
    ju = jes.es_update(jparams, jax.random.key(4), jl, sigma=0.02, lr=0.05)
    tu = es.es_update(tparams, trandom.key(4),
                      torch.tensor(np.asarray(jl)), sigma=0.02, lr=0.05)
    for want, got in zip(_jleaves(ju), _tleaves(tu)):
        assert np.abs(got - want).max() <= ES_TOL
    # nothing was updated in place
    for got, want in zip(_tleaves(tparams), _jleaves(micro_params)):
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_es_update_normalises_by_the_population_std():
    """ddof 0, as ``jnp.std``: two candidates with losses 1 and 3 have
    advantages -1 and +1 exactly."""
    params = {"w": torch.zeros(4)}
    key = trandom.key(2)
    got = es.es_update(params, key, torch.tensor([1.0, 3.0]), sigma=1.0,
                       lr=2.0)
    eps = [es.candidate_params(params, key, i, 1.0)["w"] for i in (0, 1)]
    want = -(2.0 / 2) * (-1.0 * eps[0] + 1.0 * eps[1])
    assert torch.allclose(got["w"], want, atol=1e-6)


# -- (c) PoUWTrainer against the reference ------------------------------------

def test_full_mode_losses_within_tolerance_over_3_blocks(full_pair):
    jt, tt, jrecs, trecs = full_pair
    assert len(trecs) == 3
    for j, t in zip(jrecs, trecs):
        assert abs(t.loss - j.loss) <= FULL_TOL * abs(j.loss)
    assert tt.ledger.verify_chain()
    assert tt.book.total_issued == jt.book.total_issued == 3 * 50.0
    assert sorted(tt.book.balances) == sorted(jt.book.balances) == \
        list(range(4))


def test_first_optimal_block_picks_the_references_winner(optimal_pair):
    jt, tt, jrec, trec, init = optimal_pair
    assert abs(trec.loss - jrec.loss) <= ES_TOL
    assert tt.ledger.blocks[0].winner == jt.ledger.blocks[0].winner
    # the block's candidate losses, from the key it split off the
    # trainer's key(seed + 1)
    jl, _ = jes.es_block(jsteps.make_eval_step(jmt.MICRO_CONFIG),
                         jax.tree.map(jax.numpy.asarray, init),
                         jt.pipeline.batch(0),
                         jax.random.split(jax.random.key(1))[1], **ES)
    tl, tbest = es.es_block(tsteps.make_eval_step(tmt.MICRO_CONFIG),
                            params_from_jax(init, device=CPU),
                            tt.pipeline.batch(0),
                            trandom.split(trandom.key(1))[1], **ES)
    assert np.abs(_t(tl) - np.asarray(jl)).max() <= ES_TOL
    assert float(tl[tbest]) == trec.loss
    assert int(tbest) % 4 == tt.ledger.blocks[0].winner
