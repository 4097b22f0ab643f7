#!/usr/bin/env python3
"""Microbenchmarks behind the WKV-6 kernel's design, on one CUDA card.

    python3 chip_probes.py

Prints one JSON line per probe, each with the card's name and power limit:
  1. shared_loads: the shared-memory pipe's cycles per warp-wide load, for
     a 16-byte load whose lanes read 1, 4 (lane % 4), 4 in runs of 8
     neighbouring lanes (lane / 8 % 4), or 32 addresses, an 8-byte and a
     4-byte load, and a shuffle;
  2. fp32_issue: FP32 instructions a scheduler issues per cycle, with one
     and two warps on it, for 4 and 16 independent FMA chains a thread;
  3. wkv6_step_loop: the instructions of the WKV-6 kernels' step loop
     (one step of a warp), by opcode, read from the built library's SASS;
  4. wkv6_per_step: the WKV-6 kernel of ``src/repro_torch/kernels/csrc``
     (bf16 r, k, v, K = V = 64, S 2048, from a state) in cycles per step,
     at 1, 2, 3 and 4 heads per SM and at rwkv6-7b's grid (B 8, H 64).
Cycles are elapsed time at the card's maximum SM clock (read from
nvidia-smi). The probes' kernels are built with nvcc into
``build/repro_torch_probes/``; the WKV-6 library is built as the port builds
it. Without a card the script exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PROBES_CU = r"""
#include <cuda_runtime.h>
// shared-memory loads: MODE 0 16 B one address, 1 16 B lane % 4, 2 16 B
// lane / 8 % 4, 3 16 B 32 addresses, 4 8 B 32 addresses, 5 4 B 32
// addresses, 6 shuffles
template <int MODE>
__global__ void lds(float* out, int iters) {
    __shared__ float4 buf[2048];
    for (int i = threadIdx.x; i < 2048; i += blockDim.x)
        buf[i] = make_float4(i, i + 1, i + 2, i + 3);
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int idx = MODE == 0 ? 0 : MODE == 1 ? (lane & 3)
                  : MODE == 2 ? ((lane >> 3) & 3) : lane;
    const float* f1 = reinterpret_cast<const float*>(buf);
    const float2* f2 = reinterpret_cast<const float2*>(buf);
    float a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int at = (idx + 32 * j + (i & 7) * 64) & 2047;
            if (MODE == 5) {
                a0 += f1[at];
            } else if (MODE == 4) {
                const float2 x = f2[at];
                a0 += x.x; a1 += x.y;
            } else if (MODE == 6) {
                a0 += __shfl_xor_sync(0xffffffffu, a1 + j, (j & 15) | 1);
                a1 += a0;
            } else {
                const float4 x = buf[at];
                a0 += x.x; a1 += x.y; a2 += x.z; a3 += x.w;
            }
        }
    }
    if (a0 + a1 + a2 + a3 == 12345.f) out[threadIdx.x] = a0;
}
// CH independent chains of (FMUL, FFMA, FFMA) a thread
template <int CH>
__global__ void fp32(float* out, int iters, float a, float b) {
    float x[CH], y[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) { x[c] = threadIdx.x + c; y[c] = c; }
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            const float kv = y[c] * b;
            x[c] = fmaf(a, x[c], kv);
            y[c] = fmaf(x[c], a, y[c]);
        }
    }
    float s = 0;
#pragma unroll
    for (int c = 0; c < CH; ++c) s += x[c] + y[c];
    if (s == 1234.5f) out[threadIdx.x] = s;
}
extern "C" int probe_lds(int mode, float* out, int blocks, int threads,
                         int iters) {
    switch (mode) {
    case 0: lds<0><<<blocks, threads>>>(out, iters); break;
    case 1: lds<1><<<blocks, threads>>>(out, iters); break;
    case 2: lds<2><<<blocks, threads>>>(out, iters); break;
    case 3: lds<3><<<blocks, threads>>>(out, iters); break;
    case 4: lds<4><<<blocks, threads>>>(out, iters); break;
    case 5: lds<5><<<blocks, threads>>>(out, iters); break;
    case 6: lds<6><<<blocks, threads>>>(out, iters); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
extern "C" int probe_fp32(int chains, float* out, int blocks, int threads,
                          int iters) {
    if (chains == 4)
        fp32<4><<<blocks, threads>>>(out, iters, 0.999f, 1e-3f);
    else if (chains == 16)
        fp32<16><<<blocks, threads>>>(out, iters, 0.999f, 1e-3f);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
"""
LDS_MODES = {0: "16 B, one address", 1: "16 B, 4 addresses (lane % 4)",
             2: "16 B, 4 addresses in runs of 8 lanes (lane / 8 % 4)",
             3: "16 B, 32 addresses", 4: "8 B, 32 addresses",
             5: "4 B, 32 addresses", 6: "shuffle"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def elapsed_ms(launch) -> float:
    """Median of 3 event-timed runs of ``launch`` after a warm-up."""
    import torch
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_probes() -> ctypes.CDLL:
    from repro_torch.kernels import native
    out = ROOT / "build" / "repro_torch_probes"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "probes.cu", out / "libprobes.so"
    src.write_text(PROBES_CU)
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True, capture_output=True,
                   timeout=600)
    probes = ctypes.CDLL(str(lib))
    for fn in (probes.probe_lds, probes.probe_fp32):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    return probes


def step_loop_counts(lib: Path) -> dict:
    """Opcodes of each WKV-6 kernel's step loop: the shortest loop (a
    backward branch and the code it jumps over) that holds 128 FFMA or
    more and 3 shuffles, in the library's SASS (cuobjdump)."""
    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") \
        / "bin" / "cuobjdump"
    exe = str(tool) if tool.exists() else shutil.which("cuobjdump")
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for func in text.split("Function : ")[1:]:
        head = func.split("\n", 1)[0]
        if "wkv6_kernel" not in head:
            continue
        code = []
        for line in func.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)(.*)", line)
            if m:
                code.append((int(m[1], 16), m[2], m[3]))
        loops = []
        for addr, op, rest in code:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op != "BRA" or not target or int(target[1], 16) >= addr:
                continue
            body = [o for a, o, _ in code if int(target[1], 16) <= a <= addr]
            if body.count("FFMA") >= 128 and body.count("SHFL.BFLY") >= 3:
                loops.append(body)
        body = min(loops, key=len)
        name = "wkv6_kernel<bf16>" if "bfloat16" in head else \
            "wkv6_kernel<f32>"
        out[name] = {"instructions": len(body),
                     "opcodes": dict(collections.Counter(body)
                                     .most_common())}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import native
    from repro_torch.kernels.wkv6 import wkv6_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit, mhz = (x.strip() for x in smi.split(","))
    gpu, hz = f"{name}, {limit} W", float(mhz) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    probes = build_probes()
    out = torch.zeros(1024, device="cuda")

    def run(fn, *args):
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"probe launch failed ({rc})")

    # 1. shared loads: 64 warps an SM, 16 loads an iteration
    iters, threads = 4096, 256
    blocks = sms * 2048 // threads
    per_sm = blocks * threads // 32 * iters * 16 / sms
    emit({"probe": "shared_loads", "gpu": gpu,
          "cycles_per_warp_instruction_per_sm": {
              LDS_MODES[mode]: elapsed_ms(lambda: run(
                  probes.probe_lds, mode, out.data_ptr(), blocks, threads,
                  iters)) * 1e-3 * hz / per_sm
              for mode in LDS_MODES}})

    # 2. FP32 issue: 3 instructions a chain and iteration
    iters, res = 20000, {}
    for chains in (4, 16):
        for warps in (1, 2):
            ms = elapsed_ms(lambda: run(probes.probe_fp32, chains,
                                        out.data_ptr(), sms, 128 * warps,
                                        iters))
            res[f"{chains} chains, {warps} warp(s) a scheduler"] = \
                3 * chains * iters * warps / (ms * 1e-3 * hz)
    emit({"probe": "fp32_issue", "gpu": gpu,
          "instructions_per_cycle_per_scheduler": res})

    # 3. the WKV-6 step loop's instructions
    lib, _ = native.build()
    emit({"probe": "wkv6_step_loop", "gpu": gpu,
          "per_warp_and_step": step_loop_counts(lib)})

    # 4. WKV-6 per step against heads per SM
    native.library()
    steps, res = 2048, {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for B, H in ((1, sms), (2, sms), (3, sms), (4, sms), (8, 64)):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        r, k, v = (randn(B, steps, H, 64).bfloat16() for _ in range(3))
        w = torch.rand((B, steps, H, 64), generator=gen, device="cuda") \
            * 0.5 + 0.5
        u, s0 = randn(H, 64), randn(B, H, 64, 64)

        def call():
            for _ in range(5):
                wkv6_cuda(r, k, v, w, u, s0)
        ms = elapsed_ms(call) / 5
        res[f"B={B} H={H} ({B * H / sms:.2f} heads an SM)"] = {
            "ms": ms, "cycles_per_step": ms * 1e-3 * hz / steps}
        del r, k, v, w, u, s0
    emit({"probe": "wkv6_per_step", "gpu": gpu, "clock_hz": hz,
          "shape": "S=2048 K=V=64, r/k/v bf16, from a state", **res})
    return 0


if __name__ == "__main__":
    sys.exit(main())
