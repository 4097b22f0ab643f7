"""Build and load the hand-written CUDA kernels under ``csrc/``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into one shared library with a plain
C interface, and loaded with ``ctypes``. The build runs at first use, into
``build/repro_torch_kernels/`` at the root of the checkout, and is reused
while the sources and flags stay the same. Nothing is built on import: the
CPU tests import every module on a machine with no ``nvcc``.

The port keeps 32-bit words in int64 tensors masked to 32 bits. The SHA-256
kernel reads and writes those int64 words itself (the low 32 bits of each);
the Merkle kernel takes the numpy uint32 digests as int32 buffers of the
same bits (read as ``uint32_t`` in C).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Tuple

import torch

MASK32 = 0xFFFFFFFF

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH]


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _tag(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Tuple[Path, str]:
    """Compile and link ``csrc/*.cu``; returns (library path, nvcc log).

    The log holds ``-Xptxas -v``'s register and spill counts per kernel."""
    cu = sorted(CSRC.glob("*.cu"))
    tag = _tag(cu + sorted(CSRC.glob("*.cuh")))
    lib = BUILD_DIR / f"libpnp_kernels_{tag}.so"
    log = BUILD_DIR / f"libpnp_kernels_{tag}.log"
    if lib.exists() and log.exists():
        return lib, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        texts = []
        try:
            for src, proc in zip(cu, procs):
                out, _ = proc.communicate()
                texts.append(f"== {src.name}\n{out}")
                if proc.returncode:
                    raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        text = "\n".join(texts)
        log.write_text(text)
        os.replace(tmp_lib, lib)
    return lib, text


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.pnp_sha256_rows.argtypes = [vp, i64, i32, vp, vp, i32, vp]
    lib.pnp_sha256_rows.restype = ctypes.c_int
    lib.pnp_merkle_reduce.argtypes = [vp, i64, i64, i64, i32, vp, vp, vp,
                                      i32, vp]
    lib.pnp_merkle_reduce.restype = ctypes.c_int
    lib.pnp_merkle_workspace_words.argtypes = [i64, i64, i64, i32]
    lib.pnp_merkle_workspace_words.restype = ctypes.c_int64
    lib.pnp_flash_attention_fwd.argtypes = [vp, vp, vp, vp, i64, i64, i64,
                                            i32, i32, i32, i32, i32, i32, vp]
    lib.pnp_flash_attention_fwd.restype = ctypes.c_int
    lib.pnp_flash_attention_fwd_lse.argtypes = [vp, vp, vp, vp, vp, i64,
                                                i64, i64, i32, i32, i32, i32,
                                                i32, vp]
    lib.pnp_flash_attention_fwd_lse.restype = ctypes.c_int
    lib.pnp_flash_attention_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                            vp, vp, i64, i64, i64, i32, i32,
                                            i32, i32, i32, i64, vp]
    lib.pnp_flash_attention_bwd.restype = ctypes.c_int
    lib.pnp_flash_attention_bwd_workspace_words.argtypes = [
        i64, i64, i64, i32, i32, i32, i32, i64]
    lib.pnp_flash_attention_bwd_workspace_words.restype = ctypes.c_int64
    lib.pnp_flash_attention_bwd_info.argtypes = [i32, vp]
    lib.pnp_flash_attention_bwd_info.restype = ctypes.c_int
    lib.pnp_flash_attention_info.argtypes = [i32, vp]
    lib.pnp_flash_attention_info.restype = ctypes.c_int
    lib.pnp_flash_attention_tc_fwd.argtypes = [vp, vp, vp, vp, i64, i64, i64,
                                               i32, i32, i32, i32, i32, vp]
    lib.pnp_flash_attention_tc_fwd.restype = ctypes.c_int
    lib.pnp_flash_attention_tc_fwd_lse.argtypes = [vp, vp, vp, vp, vp, i64,
                                                   i64, i64, i32, i32, i32,
                                                   i32, i32, vp]
    lib.pnp_flash_attention_tc_fwd_lse.restype = ctypes.c_int
    lib.pnp_flash_attention_tc_info.argtypes = [i32, i32, vp, vp, vp]
    lib.pnp_flash_attention_tc_info.restype = ctypes.c_int
    lib.pnp_flash_attention_tc_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                               vp, vp, vp, vp, vp, i64, i64,
                                               i64, i64, i32, i32, i32, i32,
                                               i32, vp]
    lib.pnp_flash_attention_tc_bwd.restype = ctypes.c_int
    lib.pnp_flash_attention_tc_bwd_info.argtypes = [i32, vp]
    lib.pnp_flash_attention_tc_bwd_info.restype = ctypes.c_int
    lib.pnp_wkv6.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i32,
                             i32, i32, i32, vp]
    lib.pnp_wkv6.restype = ctypes.c_int
    lib.pnp_decay_scan.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, vp,
                                   vp]
    lib.pnp_decay_scan.restype = ctypes.c_int
    lib.pnp_decay_scan_per_chain.argtypes = [vp, vp, vp, vp, vp, i64, i64,
                                             i64, vp]
    lib.pnp_decay_scan_per_chain.restype = ctypes.c_int
    lib.pnp_decay_scan_workspace_words.argtypes = [i64, i64]
    lib.pnp_decay_scan_workspace_words.restype = ctypes.c_int64
    lib.pnp_decay_scan_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i64,
                                       i64, i64, vp]
    lib.pnp_decay_scan_bwd.restype = ctypes.c_int
    lib.pnp_wkv6_bwd.argtypes = [vp] * 14 + [i64, i64, i32, i32, i32, i32,
                                             vp]
    lib.pnp_wkv6_bwd.restype = ctypes.c_int
    lib.pnp_wkv6_bwd_workspace_words.argtypes = [i64, i64, i32, i32]
    lib.pnp_wkv6_bwd_workspace_words.restype = ctypes.c_int64
    lib.pnp_wkv6_bwd_info.argtypes = [vp]
    lib.pnp_wkv6_bwd_info.restype = ctypes.c_int
    lib.pnp_flash_attention_mma_bwd.argtypes = [vp] * 11 + [
        i64, i64, i64, i32, i32, i32, i32, vp]
    lib.pnp_flash_attention_mma_bwd.restype = ctypes.c_int
    lib.pnp_flash_attention_mma_bwd_info.argtypes = [vp]
    lib.pnp_flash_attention_mma_bwd_info.restype = ctypes.c_int
    return lib


def check_cuda_words(name: str, t: torch.Tensor, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous int64 word tensor on a CUDA card."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, dtypes, head_dims) -> None:
    """Raise unless q (B, S, H, hd) and k, v (B, T, Kv, hd) are contiguous
    tensors of one dtype out of ``dtypes`` on one CUDA card, each starting
    on a 16-byte boundary, with hd in ``head_dims``, H % Kv == 0, T >= 1
    and ``window`` >= 0 (the flash-attention kernels' inputs)."""
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected a "
                             "CUDA tensor")
        if t.device != q.device:
            raise ValueError(f"{name}: q, k, v on different devices")
        if t.dtype not in dtypes or t.dtype != q.dtype:
            allowed = " or all ".join(str(d).split(".")[1] for d in dtypes)
            raise TypeError(f"{name}: {arg} is {t.dtype}; q, k, v must all "
                            f"be {allowed}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             "expected 4 dims")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte "
                             "boundary")
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, Kv, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in head_dims:
        raise ValueError(f"{name}: head_dim {hd} not in {tuple(head_dims)}")
    if Kv < 1 or H % Kv:
        raise ValueError(f"{name}: {H} heads over {Kv} KV heads")
    if T < 1:
        raise ValueError(f"{name}: no keys")
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current stream on ``t``'s card (read without
    building a ``torch.cuda.Stream``: a launch's host time counts where the
    kernel is short). The accessor is private to torch: chip_smoke.py and
    ``test_stream_handle_is_the_current_streams`` hold it to
    ``torch.cuda.current_stream().cuda_stream``."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


class KernelLaunchError(RuntimeError):
    """A hand-written kernel failed to launch (a fault of the card, not of
    the data it was given)."""


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise KernelLaunchError(
            f"{name}: kernel launch failed with CUDA error {rc}")
