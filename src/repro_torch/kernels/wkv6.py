"""Binding of the hand-written CUDA WKV-6 kernel (``csrc/wkv6.cu``).

It replaces the Pallas kernel of ``repro/kernels/wkv6.py``: the RWKV-6
recurrence o_t = r_tᵀ(S + (u⊙k_t)v_tᵀ), S ← diag(w_t)S + k_t v_tᵀ over a
whole sequence in one launch, the K x V state in float32. It reads r, k,
v, w in the model's (B, S, H, K) layout, with no fold or transpose copy.
``kernels/ops.py`` sends CUDA tensors here and CPU tensors to
``ref.wkv6_ref``.

For training, ``WKV6`` is the autograd Function: its forward is
``wkv6_cuda``, its backward ``wkv6_bwd_cuda``, the hand-written backward of
``csrc/wkv6_bwd.cu``, which recomputes the states from the saved inputs
(plain version: ``ref.wkv6_bwd_ref``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import native

MAX_DIM = 64                       # K and V a block holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (a run shows its path went through
# the kernel by reading this; only the launch below adds to it), and calls
# of the backward (``wkv6_bwd_cuda``: its two kernels once each).
launches = 0
bwd_launches = 0


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtypes, shape) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"wkv6_cuda: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"wkv6_cuda: {name} is {t.dtype}, expected one of "
                        f"{[str(d) for d in dtypes]}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"wkv6_cuda: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"wkv6_cuda: {name} must be contiguous")


def _check_inputs(name, r, k, v, w, u, s0):
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: r {tuple(r.shape)} and v "
                         f"{tuple(v.shape)} must have 4 dims")
    B, S, H, K = r.shape
    V = v.shape[-1]
    dev = r.device
    _check("r", r, dev, _DTYPES, (B, S, H, K))
    _check("k", k, dev, (r.dtype,), (B, S, H, K))
    _check("v", v, dev, (r.dtype,), (B, S, H, V))
    _check("w", w, dev, (torch.float32,), (B, S, H, K))
    _check("u", u, dev, (torch.float32,), (H, K))
    if s0 is not None:
        _check("s0", s0, dev, (torch.float32,), (B, H, K, V))
    if not (1 <= K <= MAX_DIM and 1 <= V <= MAX_DIM):
        raise ValueError(f"{name}: K={K}, V={V}; each must lie in "
                         f"[1, {MAX_DIM}]")
    return B, S, H, K, V


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k: (B, S, H, K) and v: (B, S, H, V), all float32 or all bfloat16;
    w: (B, S, H, K) float32; u: (H, K) float32; s0: (B, H, K, V) float32 or
    None (zeros); all contiguous on one CUDA card, K and V at most 64.
    Returns (out (B, S, H, V), s_final (B, H, K, V)), both float32."""
    global launches
    B, S, H, K, V = _check_inputs("wkv6_cuda", r, k, v, w, u, s0)
    dev = r.device
    out = torch.empty((B, S, H, V), dtype=torch.float32, device=dev)
    s_final = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    if B and H:
        with torch.cuda.device(dev):
            rc = native.library().pnp_wkv6(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if s0 is None else s0.data_ptr(),
                out.data_ptr(), s_final.data_ptr(), B, S, H, K, V,
                _DTYPES[r.dtype], native.stream_of(r))
        launches += 1
        native.check_launch("wkv6_cuda", rc)
    return out, s_final


def wkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                  ds_final: Optional[torch.Tensor] = None,
                  s0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """The gradients (dr, dk, dv, dw, du) of ``wkv6_cuda``'s (out, s_final)
    from dout (B, S, H, V) float32 and ds_final (B, H, K, V) float32 or
    None (zeros), at the forward's inputs (s0 the start it ran from). dr,
    dk, dv in r's dtype; dw (B, S, H, K) and du (H, K, summed over the
    batch in order) float32. Two launches of ``csrc/wkv6_bwd.cu``: the
    backward, then du's sum over the batch."""
    global bwd_launches
    B, S, H, K, V = _check_inputs("wkv6_bwd_cuda", r, k, v, w, u, s0)
    dev = r.device
    _check("dout", dout, dev, (torch.float32,), (B, S, H, V))
    if ds_final is not None:
        _check("ds_final", ds_final, dev, (torch.float32,), (B, H, K, V))
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dw = torch.empty_like(w)
    du = torch.empty((H, K), dtype=torch.float32, device=dev)
    lib = native.library()
    ws = torch.empty(lib.pnp_wkv6_bwd_workspace_words(B, S, H, K),
                     dtype=torch.float32, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        rc = lib.pnp_wkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), ptr(s0), dout.data_ptr(), ptr(ds_final),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), ws.data_ptr(), B, S, H, K, V, _DTYPES[r.dtype],
            native.stream_of(r))
    bwd_launches += 1
    native.check_launch("wkv6_bwd_cuda", rc)
    return dr, dk, dv, dw, du


def bwd_resources() -> dict:
    """The backward kernel's shared bytes a block and what the runtime
    reports for each dtype's instance: registers a thread and local
    (spilled) bytes."""
    import ctypes
    out = (ctypes.c_int32 * 5)()
    native.check_launch("wkv6_bwd info",
                        native.library().pnp_wkv6_bwd_info(out))
    return {"shared_bytes": out[0],
            "float32": {"registers": out[1], "local_bytes": out[2]},
            "bfloat16": {"registers": out[3], "local_bytes": out[4]}}


class WKV6(torch.autograd.Function):
    """The WKV-6 recurrence with its gradient on the card: forward
    ``wkv6_cuda``, backward ``wkv6_bwd_cuda`` on the saved inputs. s0 takes
    no gradient (``kernels/ops.py`` raises if it asks for one)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        out, s_final = wkv6_cuda(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return out, s_final

    @staticmethod
    def backward(ctx, dout, ds_final):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dout is None:
            B, S, H, _ = r.shape
            dout = torch.zeros((B, S, H, v.shape[-1]), dtype=torch.float32,
                               device=r.device)
        dr, dk, dv, dw, du = wkv6_bwd_cuda(
            r, k, v, w, u, dout.contiguous(),
            None if ds_final is None else ds_final.contiguous(), s0)
        return dr, dk, dv, dw, du, None
