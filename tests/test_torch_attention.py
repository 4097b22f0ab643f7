"""The port's attention against the JAX package on the CPU: the plain flash
attention (what the CUDA kernel is held to on the card), the layers, and
the prefill and decode attention on the same converted weights.

Inputs are made from a seed with numpy and handed to both packages. The
reference's Pallas flash kernel runs in interpret mode, as
``tests/test_kernels.py`` runs it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import (flash_attention, flash_attention_tc,  # noqa: E402
                                 ops, ref)
from repro_torch.models import attention, layers  # noqa: E402

CPU = "cpu"
# tests/test_kernels.py::TestFlashAttention's shapes: (B, S, T, H, Kv, hd)
FLASH_SHAPES = [(1, 32, 32, 2, 1, 8), (2, 64, 64, 4, 2, 16),
                (1, 48, 48, 3, 3, 8)]
FLASH_TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(shape, seed):
    B, S, T, H, Kv, hd = shape
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(B, S, H, hd)).astype(np.float32),
            rs.normal(size=(B, T, Kv, hd)).astype(np.float32),
            rs.normal(size=(B, T, Kv, hd)).astype(np.float32))


def _torch_flash(q, k, v, causal):
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    return out.numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# --------------------------------------------------------------------------
# flash attention, plain version
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_chunked_attention_and_pallas(shape, causal):
    q, k, v = _qkv(shape, sum(shape))
    got = _torch_flash(q, k, v, causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jattn.chunked_attention(jq, jk, jv, causal=causal, chunk=8),
           FLASH_TOL)
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                     backend="pallas", bq=16, bk=16),
           FLASH_TOL)


def test_flash_ref_online_softmax_stability():
    """test_kernels.py's large equal scores: all 30.0 gives exactly 1."""
    q = torch.full((1, 32, 1, 8), 30.0)
    out = ops.flash_attention(q, q.clone(), torch.ones(1, 32, 1, 8),
                              causal=True)
    assert torch.isfinite(out).all()
    _close(out.numpy(), 1.0, dict(rtol=1e-5, atol=0))


@pytest.mark.parametrize("shape,causal", [
    ((2, 33, 33, 4, 2, 32), True),        # ragged S = T = 33, GQA
    ((2, 33, 33, 4, 2, 32), False),
    ((1, 20, 45, 4, 1, 16), False),       # S != T
])
def test_flash_ref_ragged_matches_chunked_attention(shape, causal):
    q, k, v = _qkv(shape, 7)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal)
    _close(_torch_flash(q, k, v, causal), want, FLASH_TOL)


def test_flash_ref_keeps_the_dtype_and_head_mapping():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 5, 5, 4, 2, 8), 3))
    out = ref.flash_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  causal=False)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    # query heads 0, 1 read KV head 0; heads 2, 3 read KV head 1
    solo = ref.flash_attention_ref(q[:, :, 2:3], k[:, :, 1:2], v[:, :, 1:2],
                                   causal=False)
    full = ref.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(full[:, :, 2:3], solo, rtol=0, atol=0)


def test_flash_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 2, 32)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(q, q, q, causal=True)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(q.to("meta"), q, q, causal=True)
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 256, "tensor_core"), (torch.bfloat16, 32, "cuda_core"),
    (torch.bfloat16, 80, "tensor_core"), (torch.float32, 80, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core"),
    (torch.float32, 256, "cuda_core"), (torch.float32, 32, "cuda_core"),
    (torch.float16, 128, "cuda_core")])
def test_flash_dispatch_rule(dtype, hd, kernel):
    """bfloat16 at head dims 64, 80, 128 and 256 takes the tensor-core
    kernel; everything else the CUDA-core kernel (which refuses what it does not
    take, float16 among it)."""
    assert flash_attention.kernel_for(dtype, hd) == kernel


def test_tensor_core_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    before = flash_attention_tc.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_tc.flash_attention_tc_cuda(q, q, q, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(q, q, q, causal=True)
    assert flash_attention_tc.launches == before


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_norms_rope_and_mlp_match_reference():
    rs = np.random.RandomState(0)
    x = rs.normal(size=(2, 7, 4, 32)).astype(np.float32)
    g = (0.1 * rs.normal(size=(32,))).astype(np.float32)
    tx, tg, jx, jg = torch.from_numpy(x), torch.from_numpy(g), \
        jnp.asarray(x), jnp.asarray(g)
    _close(layers.rms_norm(tx, tg), jlayers.rms_norm(jx, jg), LAYER_TOL)
    _close(layers.head_rms_norm(tx, tg), jlayers.head_rms_norm(jx, jg),
           LAYER_TOL)
    pos1 = np.arange(3, 10)
    pos2 = rs.randint(0, 500, size=(2, 7))
    for pos in (pos1, pos2):
        _close(layers.apply_rope(tx, torch.from_numpy(pos), 1e6),
               jlayers.apply_rope(jx, jnp.asarray(pos), 1e6), LAYER_TOL)
    _close(layers.apply_rope(tx, torch.from_numpy(pos1), 1e4),
           jlayers.apply_rope(jx, jnp.asarray(pos1), 1e4), LAYER_TOL)
    jp = jlayers.init_mlp(jax.random.key(1), 32, 48, jnp.float32)
    h = x.reshape(2, 28, 32)
    _close(layers.mlp(params_from_jax(jp, device=CPU), torch.from_numpy(h)),
           jlayers.mlp(jp, jnp.asarray(h)), LAYER_TOL)


# --------------------------------------------------------------------------
# prefill and decode attention
# --------------------------------------------------------------------------

ATTN = dict(n_heads=4, n_kv=2, head_dim=32, rope_theta=1e6, qk_norm=True)


def _attn_params():
    jp = jattn.init_attention(jax.random.key(2), 64, 4, 2, 32, jnp.float32,
                              qk_norm=True)
    # non-zero qk-norm gains, so the norms are exercised
    rs = np.random.RandomState(5)
    jp["q_norm"] = jnp.asarray(0.1 * rs.normal(size=(32,)), jnp.float32)
    jp["k_norm"] = jnp.asarray(0.1 * rs.normal(size=(32,)), jnp.float32)
    return jp, params_from_jax(jp, device=CPU)


def _assert_cache_equal(tc, jc):
    for name in ("k", "v", "slot_pos"):
        _close(tc[name].numpy(), jc[name], LAYER_TOL)


@pytest.mark.parametrize("cache_len", [24, 8], ids=["C>=S", "C<S"])
def test_prefill_then_decode_attention_match_reference(cache_len):
    jp, tp = _attn_params()
    B, S = 2, 13
    x = np.random.RandomState(9).normal(size=(B, S + 3, 64)).astype(
        np.float32)
    jc = jattn.init_kv_cache(B, cache_len, 2, 32, jnp.float32)
    tc = attention.init_kv_cache(B, cache_len, 2, 32, torch.float32)
    jout, jc = jattn.prefill_self_attention(jp, jnp.asarray(x[:, :S]), jc,
                                            **ATTN)
    tout, tc = attention.prefill_self_attention(
        tp, torch.from_numpy(x[:, :S]), tc, **ATTN)
    _close(tout.numpy(), jout, LAYER_TOL)
    _assert_cache_equal(tc, jc)
    for pos in range(S, S + 3):
        step = x[:, pos:pos + 1]
        jout, jc = jattn.decode_self_attention(jp, jnp.asarray(step), jc,
                                               jnp.int32(pos), **ATTN)
        tout, tc = attention.decode_self_attention(
            tp, torch.from_numpy(step), tc, pos, **ATTN)
        _close(tout.numpy(), jout, LAYER_TOL)
        _assert_cache_equal(tc, jc)
