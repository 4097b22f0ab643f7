"""The port's recurrent kernels and layers against the JAX package on the
CPU: the decay scan and WKV-6 (the plain versions the CUDA kernels are held
to on the card), the RG-LRU block, RWKV-6's time and channel mix, and the
windowed flash attention.

Inputs are made from a seed with numpy and handed to both packages. The
reference's Pallas kernels run in interpret mode, as
``tests/test_kernels.py`` runs them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import rglru, rwkv6  # noqa: E402

CPU = "cpu"
DECAY_TOL = dict(rtol=1e-5, atol=1e-5)
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------
# decay scan
# --------------------------------------------------------------------------


def _decay_inputs(shape):
    B, S, C = shape
    rs = np.random.RandomState(sum(shape))
    return (rs.uniform(0.3, 1.0, shape).astype(np.float32),
            rs.normal(size=shape).astype(np.float32),
            rs.normal(size=(B, C)).astype(np.float32))


# tests/test_kernels.py::TestDecayScan's shapes
@pytest.mark.parametrize("shape", [(1, 4, 8), (2, 37, 130), (3, 64, 256),
                                   (1, 128, 129)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_decay_scan_matches_pallas_and_ref(shape, with_h0):
    a, b, h0 = _decay_inputs(shape)
    h0 = h0 if with_h0 else None
    got, got_last = ops.decay_scan(_t(a), _t(b),
                                   None if h0 is None else _t(h0))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jh0 = None if h0 is None else jnp.asarray(h0)
    want, want_last = jops.decay_scan(ja, jb, jh0, backend="pallas",
                                      seq_chunk=16)
    _close(got, want, DECAY_TOL)
    _close(got_last, want_last, DECAY_TOL)
    _close(got, jref.decay_scan_ref(ja, jb, jh0), DECAY_TOL)


def test_decay_scan_chunk_carry_equals_one_call():
    a, b, h0 = _decay_inputs((2, 32, 16))
    whole, whole_last = ops.decay_scan(_t(a), _t(b), _t(h0))
    parts, parts_last = ops.decay_scan(_t(a), _t(b), _t(h0), seq_chunk=16)
    _close(parts, whole, DECAY_TOL)
    _close(parts_last, whole_last, DECAY_TOL)
    first = ref.decay_scan_ref(_t(a[:, :16]), _t(b[:, :16]), _t(h0))
    second = ref.decay_scan_ref(_t(a[:, 16:]), _t(b[:, 16:]), first[:, -1])
    _close(second, whole[:, 16:], DECAY_TOL)


@pytest.mark.parametrize("with_h0", [True, False])
def test_decay_scan_of_no_steps_keeps_h0(with_h0):
    # the card's kernel returns h0 (or zeros) as h_last for S = 0; the
    # plain version does the same
    a, b, h0 = _decay_inputs((2, 0, 5))
    h, last = ops.decay_scan(_t(a), _t(b), _t(h0) if with_h0 else None)
    assert tuple(h.shape) == (2, 0, 5)
    _close(last, h0 if with_h0 else np.zeros((2, 5), np.float32),
           dict(rtol=0, atol=0))


def test_decay_scan_matches_sequential_python():
    a, b, _ = _decay_inputs((1, 9, 3))
    h, want = np.zeros((1, 3), np.float32), []
    for t in range(9):
        h = a[:, t] * h + b[:, t]
        want.append(h.copy())
    _close(ops.decay_scan(_t(a), _t(b))[0], np.stack(want, axis=1),
           dict(rtol=1e-5, atol=1e-6))


# --------------------------------------------------------------------------
# WKV-6
# --------------------------------------------------------------------------


def _wkv_inputs(shape):
    B, S, H, K, V = shape
    rs = np.random.RandomState(sum(shape))

    def mk(*s):
        return rs.normal(size=s).astype(np.float32)
    r, k = mk(B, S, H, K), mk(B, S, H, K)
    w = (1.0 / (1.0 + np.exp(-mk(B, S, H, K))) * 0.5 + 0.5).astype(
        np.float32)
    return r, k, mk(B, S, H, V), w, mk(H, K), mk(B, H, K, V)


# tests/test_kernels.py::TestWkv6's shapes, and the reduced model's head
WKV_SHAPES = [(1, 5, 1, 4, 4), (2, 19, 3, 8, 8), (1, 33, 2, 16, 16),
              (2, 12, 8, 32, 32)]


@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_matches_pallas_and_ref(shape):
    args = _wkv_inputs(shape)
    got_o, got_s = ops.wkv6(*map(_t, args))
    jargs = tuple(map(jnp.asarray, args))
    want_o, want_s = jops.wkv6(*jargs, backend="pallas", seq_chunk=7)
    _close(got_o, want_o, WKV_TOL)
    _close(got_s, want_s, WKV_TOL)
    ref_o, ref_s = jref.wkv6_ref(*jargs)
    _close(got_o, ref_o, WKV_TOL)
    _close(got_s, ref_s, WKV_TOL)
    # the chunk-and-carry contract, and a zero state when s0 is None
    part_o, part_s = ops.wkv6(*map(_t, args), seq_chunk=4)
    _close(part_o, got_o, WKV_TOL)
    _close(part_s, got_s, WKV_TOL)
    zero_o, _ = ops.wkv6(*map(_t, args[:5]))
    _close(zero_o, jref.wkv6_ref(*jargs[:5])[0], WKV_TOL)


def _wkv6_bonus_apart(r, k, v, w, u, s0):
    """The order of sums the CUDA kernel uses, in plain PyTorch: the bonus
    is one scalar a step, o_t = r_t^T S + a_t v_t with a_t = sum_k r_tk u_k
    k_tk, then S <- diag(w_t) S + k_t v_t^T."""
    a = (r * u * k).sum(-1)                                  # (B, S, H)
    s, outs = s0.clone(), []
    for t in range(r.shape[1]):
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s)
                    + a[:, t, :, None] * v[:, t])
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    return torch.stack(outs, dim=1), s


@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_bonus_as_one_scalar_a_step(shape):
    """The kernel's rearranged arithmetic computes the same function as the
    port's plain version and the reference's."""
    args = _wkv_inputs(shape)
    got_o, got_s = _wkv6_bonus_apart(*map(_t, args))
    for want_o, want_s in (ref.wkv6_ref(*map(_t, args)),
                           jref.wkv6_ref(*map(jnp.asarray, args))):
        _close(got_o, want_o, WKV_TOL)
        _close(got_s, want_s, WKV_TOL)


def test_wkv6_one_step_by_hand():
    """test_kernels.py's hand check: o_0 = r (s0 + (u*k) v^T),
    s_1 = w*s0 + k v^T."""
    rs = np.random.RandomState(7)
    r, k = (rs.normal(size=(1, 1, 1, 3)).astype(np.float32)
            for _ in range(2))
    v = rs.normal(size=(1, 1, 1, 2)).astype(np.float32)
    w = rs.uniform(0.5, 1.0, (1, 1, 1, 3)).astype(np.float32)
    u = rs.normal(size=(1, 3)).astype(np.float32)
    s0 = rs.normal(size=(1, 1, 3, 2)).astype(np.float32)
    o, sT = ops.wkv6(*map(_t, (r, k, v, w, u, s0)))
    kv = np.einsum("k,v->kv", k[0, 0, 0], v[0, 0, 0])
    want_o = np.einsum("k,kv->v", r[0, 0, 0], s0[0, 0] + u[0][:, None] * kv)
    _close(o[0, 0, 0], want_o, dict(rtol=1e-5, atol=0))
    _close(sT[0, 0], w[0, 0, 0][:, None] * s0[0, 0] + kv,
           dict(rtol=1e-5, atol=0))


# --------------------------------------------------------------------------
# layers on converted weights
# --------------------------------------------------------------------------


def _converted(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device=CPU)


def test_rglru_block_scan_and_step_match_reference():
    d, lru, B, S = 64, 96, 2, 21
    jp = jrglru.init_rglru_block(jax.random.key(3), d, lru, jnp.float32)
    p = _converted(jp)
    rs = np.random.RandomState(4)
    x = rs.normal(size=(B, S, d)).astype(np.float32)
    h = rs.normal(size=(B, lru)).astype(np.float32)
    conv = rs.normal(size=(B, 3, lru)).astype(np.float32)
    # stateless scan
    want, _ = jrglru.rglru_block(jp, jnp.asarray(x))
    got, none = rglru.rglru_block(p, _t(x))
    assert none is None
    _close(got, want, LAYER_TOL)
    # scan from a carried state, then one decode step from the result
    jstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
    state = {"h": _t(h), "conv": _t(conv)}
    want, jstate = jrglru.rglru_block(jp, jnp.asarray(x), jstate)
    got, state = rglru.rglru_block(p, _t(x), state)
    _close(got, want, LAYER_TOL)
    for key in ("h", "conv"):
        _close(state[key], jstate[key], LAYER_TOL)
    step = rs.normal(size=(B, 1, d)).astype(np.float32)
    want, jstate = jrglru.rglru_block(jp, jnp.asarray(step), jstate)
    got, state = rglru.rglru_block(p, _t(step), state)
    _close(got, want, LAYER_TOL)
    for key in ("h", "conv"):
        _close(state[key], jstate[key], LAYER_TOL)


@pytest.mark.parametrize("with_state", [True, False])
def test_rwkv_time_and_channel_mix_match_reference(with_state):
    d, f, hd, B, S = 64, 128, 16, 2, 13
    jp = jrwkv.init_rwkv_layer(jax.random.key(5), d, f, hd, jnp.float32)
    p = _converted(jp)
    rs = np.random.RandomState(6)
    x = rs.normal(size=(B, S, d)).astype(np.float32)
    jtm = jcm = tm = cm = None
    if with_state:
        tok = rs.normal(size=(B, d)).astype(np.float32)
        wkv = rs.normal(size=(B, d // hd, hd, hd)).astype(np.float32)
        cm_tok = rs.normal(size=(B, d)).astype(np.float32)
        jtm = {"tok": jnp.asarray(tok), "wkv": jnp.asarray(wkv)}
        tm = {"tok": _t(tok), "wkv": _t(wkv)}
        jcm, cm = jnp.asarray(cm_tok), _t(cm_tok)
    want, jnew = jrwkv.time_mix(jp, jnp.asarray(x), jtm, hd)
    got, new = rwkv6.time_mix(p, _t(x), tm, hd)
    _close(got, want, LAYER_TOL)
    assert (new is None) == (jnew is None) == (not with_state)
    if with_state:
        _close(new["tok"], jnew["tok"], LAYER_TOL)
        _close(new["wkv"], jnew["wkv"], WKV_TOL)
    want, jnew = jrwkv.channel_mix(jp, jnp.asarray(x), jcm)
    got, new = rwkv6.channel_mix(p, _t(x), cm)
    _close(got, want, LAYER_TOL)
    if with_state:
        _close(new, jnew, LAYER_TOL)


# --------------------------------------------------------------------------
# windowed flash attention (plain version)
# --------------------------------------------------------------------------


# (B, S, H, Kv, hd, window): S > window + chunk, so the reference takes its
# banded branch
@pytest.mark.parametrize("shape", [(1, 100, 4, 1, 16, 16),
                                   (2, 75, 4, 2, 8, 24),
                                   (1, 64, 2, 2, 8, 8)])
def test_windowed_flash_ref_matches_chunked_attention(shape):
    B, S, H, Kv, hd, window = shape
    rs = np.random.RandomState(sum(shape))
    q = rs.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rs.normal(size=(B, S, Kv, hd)).astype(np.float32)
    v = rs.normal(size=(B, S, Kv, hd)).astype(np.float32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window)
    chunk = next(c for c in (8, 5, 4) if S % c == 0)
    assert S > window + chunk
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, chunk=chunk)
    _close(got, want, dict(rtol=2e-4, atol=2e-4))
