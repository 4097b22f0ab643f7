#!/usr/bin/env python3
"""Microbenchmarks behind the WKV-6, decay-scan and SHA-256 kernels'
designs, on one CUDA card.

    python3 chip_probes.py [probe ...]

Prints one JSON line per probe, each with the card's name and power limit
(all of them, or only those named):
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
     at 1, 2, 3 and 4 heads per SM and at rwkv6-7b's grid (B 8, H 64);
  5. int_issue: LOP3, SHF, IADD3 and IMAD warp instructions a scheduler
     issues per cycle (8 independent chains a thread), alone and in pairs,
     at 1, 2 and 4 warps a scheduler, with each probe loop's SASS opcodes:
     the integer pipe's rate behind the SHA-256 and Merkle bounds;
  6. memory_in_flight: read + write bandwidth of a streaming kernel shaped
     like the decay scan (a and b read, h written, float32) against the
     bytes of loads each SM keeps in flight; and the blocks each SM gets
     from the one-thread-a-chain decay-scan grid at recurrentgemma-2b's
     prefill (320 blocks of 64 threads);
  7. decay_scan_tiles: the tiled decay-scan kernel at (8, 4096, 2560) from
     h0 over tile shapes (steps x channels), and the one-thread-a-chain
     kernel, in turns;
  8. sha256_blocks: the SHA-256 kernel at the mining path's three shapes
     over threads a block, with and without W fixed at compile time,
     replayed from a CUDA graph;
  9. flash_tiles: the CUDA-core flash kernel in float32 (causal, TF32 off)
     over tiles (warps a block, keys a tile, stages of its K and V rings)
     at qwen3-0.6b's prefill shape, in turns with SDPA's efficient backend,
     and at pnpcoin-demo's from a CUDA graph;
 10. flash_bwd_tiles: the float32 flash backward (causal, TF32 off) over
     its tiles (the key pass's warps, keys a warp, queries a tile and
     stages; the dQ pass's stages), each held against the plain twin and
     bit-equal from launch to launch, with each variant's ptxas registers
     and spills and the source's split by kernel: at qwen3-0.6b's float32
     prefill shape by events in turns with SDPA's efficient backward, at
     pnpcoin-demo's training call from a CUDA graph (SDPA's backward too);
 11. flash_bwd_memory: the device memory a float32 flash backward call
     allocates over its inputs (outputs and workspace) at qwen3-0.6b's
     float32 prefill shape and at B 8, S = T 4096 (past the 2 GiB cap on
     dS), SDPA's efficient backward beside it; and, where the tree's
     wrapper caps dS, that second shape in chunks against one chunk in
     turns. ``--src DIR`` measures another tree's backward, as for
     merkle_host;
 12. flash_tc_bwd_tiles: the bf16 backward at the train CLI's call and
     qwen3-0.6b's prefill shape (causal), held against the plain twin and
     bit-equal from launch to launch, by events in turns with SDPA's bf16
     backward and from a CUDA graph: the tree's wrapper (its split by
     kernel and its peak memory over its inputs) and, without ``--src``,
     the sweep of its tiles (keys a block, ring stages, resident buffers,
     the register split) with each variant's ptxas registers and spills.
     ``--src DIR`` times DIR's wrapper (another tree of this repo, e.g. the
     parent's, unpacked by ``git archive``), as for merkle_host;
 13. merkle_units: the Merkle reduction over the nodes a block takes in and
     the levels it reduces them through, at the mining path's 2**20 leaves
     and a forest of 4 x 2**16, from a CUDA graph;
 14. merkle_host: the host clock of a 2**20-leaf full result's
     ``commit_root()`` split into its steps, and of
     ``recompute_roots_batched`` on it. ``--src DIR`` imports
     ``repro_torch`` from DIR/src instead (another tree of this repo, so
     two trees can be compared in turns in one run);
 15. profiler_count: whether ``torch.profiler`` records all three SHA-256
     kernels of three calls, over 200 sessions launching as soon as the
     session starts and stopping as soon as the card has synchronised,
     and 200 with quiet time at both ends, in turns (the count of
     ``tests/test_torch_cuda.py::test_sha256_call_is_one_kernel``).
 16. flash_tc_head_shapes: the bf16 tensor-core forward at head shapes no
     served path gives it, each in turns with SDPA, with its bound:
     stablelm-3b's prefill heads (B 8, S = T 2048, 32 over 32, causal) at
     hd 80, its own, and at hd 128, to show what hd 80's zero-padded
     columns cost; and arctic-480b's heads (56 over 8, G = 7, hd 128) at
     the same prefill, which no card holds at full width;
 17. remat_step: a qwen3-0.6b training step at the train CLI's batch (32 x
     256, bf16) split by CUDA events into forward, backward and optimiser,
     with its peak device memory, with ``remat`` (the config's) and
     without, in turns (on, off, off, on).
 18. ssm_cut_rounding: chip_smoke.py's train_ssm cut (rwkv6-7b, 2 layers at
     full width, batch 2 x 64, the trainer's threefry init and batch 0):
     each leaf's gradient in bf16 and in float32 (the same bf16 weights,
     widened; WKV-6 on its float32 instance), on the card and on the CPU,
     and the worst leaf's relative L2 error of each pair: how far bf16
     rounding alone moves the gradients the cut's check holds.
The tile, unit and block sweeps build their variants of the port's sources
with -D flags into their own libraries; the port's library keeps its one
tile, unit and block.
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
// integer issue: CH chains a thread; OP 0 LOP3, 1 SHF, 2 IADD3, 3 IMAD,
// 4 LOP3 and IMAD on alternate chains, 5 LOP3 and IADD3, 6 SHF and IADD3.
// Each op reads its chain and two others from the iteration before, so no
// two iterations fold together.
template <int OP>
__device__ __forceinline__ unsigned iop(unsigned x, unsigned y, unsigned z,
                                        int c) {
    unsigned d;
    const int kind = OP < 4 ? OP : OP == 4 ? (c & 1 ? 3 : 0)
                   : OP == 5 ? (c & 1 ? 2 : 0) : (c & 1 ? 2 : 1);
    if (kind == 0)
        asm volatile("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d)
                     : "r"(x), "r"(y), "r"(z));
    else if (kind == 1)
        asm volatile("shf.r.wrap.b32 %0, %1, %2, %3;" : "=r"(d)
                     : "r"(x), "r"(y), "r"(z));
    else if (kind == 2)
        d = x + y + z;
    else
        asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d)
                     : "r"(x), "r"(y), "r"(z));
    return d;
}
template <int OP, int CH>
__global__ void intops(unsigned* out, int iters, unsigned seed) {
    unsigned x[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) x[c] = seed * (threadIdx.x + c + 1);
    for (int i = 0; i < iters; ++i) {
        unsigned y[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c)
            y[c] = iop<OP>(x[c], x[(c + 1) % CH], x[(c + 3) % CH], c);
#pragma unroll
        for (int c = 0; c < CH; ++c) x[c] = y[c];
    }
    unsigned s = 0;
#pragma unroll
    for (int c = 0; c < CH; ++c) s ^= x[c];
    if (s == 0x12345u) out[threadIdx.x] = s;
}
extern "C" int probe_int(int op, unsigned* out, int blocks, int threads,
                         int iters) {
    switch (op) {
    case 0: intops<0, 8><<<blocks, threads>>>(out, iters, 7u); break;
    case 1: intops<1, 8><<<blocks, threads>>>(out, iters, 7u); break;
    case 2: intops<2, 8><<<blocks, threads>>>(out, iters, 7u); break;
    case 3: intops<3, 8><<<blocks, threads>>>(out, iters, 7u); break;
    case 4: intops<4, 8><<<blocks, threads>>>(out, iters, 7u); break;
    case 5: intops<5, 8><<<blocks, threads>>>(out, iters, 7u); break;
    case 6: intops<6, 8><<<blocks, threads>>>(out, iters, 7u); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
// decay-scan-shaped streaming: K float4 of a and of b a thread in flight,
// then K float4 of a * b + b written; grid-stride over n float4
template <int K>
__global__ void stream_rw(const float4* __restrict__ a,
                          const float4* __restrict__ b, float4* __restrict__ o,
                          long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x * K;
    for (long long i = (long long)blockIdx.x * blockDim.x * K + threadIdx.x;
         i < n; i += stride) {
        float4 x[K], y[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const long long j = i + (long long)k * blockDim.x;
            if (j < n) { x[k] = __ldcs(a + j); y[k] = __ldcs(b + j); }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const long long j = i + (long long)k * blockDim.x;
            if (j < n)
                __stcs(o + j, make_float4(fmaf(x[k].x, y[k].x, y[k].x),
                                          fmaf(x[k].y, y[k].y, y[k].y),
                                          fmaf(x[k].z, y[k].z, y[k].z),
                                          fmaf(x[k].w, y[k].w, y[k].w)));
        }
    }
}
extern "C" int probe_stream(int k, const void* a, const void* b, void* o,
                            long long n, int blocks, int threads) {
    const float4* x = (const float4*)a;
    const float4* y = (const float4*)b;
    float4* z = (float4*)o;
    switch (k) {
    case 1: stream_rw<1><<<blocks, threads>>>(x, y, z, n); break;
    case 2: stream_rw<2><<<blocks, threads>>>(x, y, z, n); break;
    case 4: stream_rw<4><<<blocks, threads>>>(x, y, z, n); break;
    case 8: stream_rw<8><<<blocks, threads>>>(x, y, z, n); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
// the SM each block of a grid runs on; blocks wait ~20 us so all that can
// be resident at once are
__global__ void smid_of_block(int* out) {
    if (threadIdx.x == 0) {
        unsigned id;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
        out[blockIdx.x] = (int)id;
        const long long t0 = clock64();
        while (clock64() - t0 < 40000) {
        }
    }
}
extern "C" int probe_smid(int* out, int blocks, int threads) {
    smid_of_block<<<blocks, threads>>>(out);
    return (int)cudaGetLastError();
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
    for fn in (probes.probe_lds, probes.probe_fp32, probes.probe_int):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    vp = ctypes.c_void_p
    probes.probe_stream.argtypes = [ctypes.c_int, vp, vp, vp,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int]
    probes.probe_smid.argtypes = [vp, ctypes.c_int, ctypes.c_int]
    for fn in (probes.probe_stream, probes.probe_smid):
        fn.restype = ctypes.c_int
    return probes


def sass_of(lib: Path) -> str:
    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") \
        / "bin" / "cuobjdump"
    exe = str(tool) if tool.exists() else shutil.which("cuobjdump")
    return subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def opcodes(text: str, name: str) -> dict:
    """Opcode counts (with their modifiers' first word) of each function
    whose mangled name holds ``name``, in SASS text."""
    out = {}
    for func in text.split("Function : ")[1:]:
        head = func.split("\n", 1)[0].strip()
        if name not in head:
            continue
        ops = collections.Counter(
            m[1] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*"
                r"(?:\.[A-Z0-9_]+)?)", func))
        ops.pop("NOP", None)
        out[head] = dict(ops.most_common())
    return out


def step_loop_counts(lib: Path) -> dict:
    """Opcodes of each WKV-6 kernel's step loop: the shortest loop (a
    backward branch and the code it jumps over) that holds 128 FFMA or
    more and 3 shuffles, in the library's SASS (cuobjdump)."""
    text = sass_of(lib)
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

    names = set(a for a in sys.argv[1:] if not a.startswith("--src"))
    unknown = names - set(PROBES)
    if unknown:
        print(f"chip_probes: no probe {sorted(unknown)}; one of {PROBES}",
              file=sys.stderr)
        return 2

    def want(probe: str) -> bool:
        return not names or probe in names

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit, mhz = (x.strip() for x in smi.split(","))
    gpu, hz = f"{name}, {limit} W", float(mhz) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    probes = build_probes()
    out = torch.zeros(1024, device="cuda")

    # 1. shared loads: 64 warps an SM, 16 loads an iteration
    iters, threads = 4096, 256
    blocks = sms * 2048 // threads
    per_sm = blocks * threads // 32 * iters * 16 / sms
    if want("shared_loads"):
        emit({"probe": "shared_loads", "gpu": gpu,
              "cycles_per_warp_instruction_per_sm": {
                  LDS_MODES[mode]: elapsed_ms(lambda: _ok(probes.probe_lds(
                      mode, out.data_ptr(), blocks, threads, iters)))
                  * 1e-3 * hz / per_sm
                  for mode in LDS_MODES}})

    # 2. FP32 issue: 3 instructions a chain and iteration
    iters, res = 20000, {}
    for chains in (4, 16) if want("fp32_issue") else ():
        for warps in (1, 2):
            ms = elapsed_ms(lambda: _ok(probes.probe_fp32(
                chains, out.data_ptr(), sms, 128 * warps, iters)))
            res[f"{chains} chains, {warps} warp(s) a scheduler"] = \
                3 * chains * iters * warps / (ms * 1e-3 * hz)
    if res:
        emit({"probe": "fp32_issue", "gpu": gpu,
              "instructions_per_cycle_per_scheduler": res})

    # 3. the WKV-6 step loop's instructions
    lib, _ = native.build()
    if want("wkv6_step_loop"):
        emit({"probe": "wkv6_step_loop", "gpu": gpu,
              "per_warp_and_step": step_loop_counts(lib)})

    # 4. WKV-6 per step against heads per SM
    native.library()
    steps, res = 2048, {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for B, H in ((1, sms), (2, sms), (3, sms), (4, sms), (8, 64)) \
            if want("wkv6_per_step") else ():
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
    if res:
        emit({"probe": "wkv6_per_step", "gpu": gpu, "clock_hz": hz,
              "shape": "S=2048 K=V=64, r/k/v bf16, from a state", **res})
    del gen
    torch.cuda.empty_cache()
    if want("int_issue"):
        probe_int_issue(probes, out, gpu, hz, sms)
    if want("memory_in_flight"):
        probe_memory(probes, gpu, sms)
    if want("decay_scan_tiles"):
        probe_decay_tiles(gpu)
    if want("sha256_blocks"):
        probe_sha_blocks(gpu)
    if want("flash_tiles"):
        probe_flash_tiles(gpu)
    if want("flash_bwd_tiles"):
        probe_flash_bwd_tiles(gpu)
    if want("flash_bwd_memory"):
        probe_flash_bwd_memory(gpu)
    if want("flash_tc_bwd_tiles"):
        probe_flash_tc_bwd_tiles(gpu)
    if want("merkle_units"):
        probe_merkle_units(gpu)
    if want("merkle_host"):
        probe_merkle_host(gpu)
    if want("profiler_count"):
        probe_profiler_count(gpu)
    if want("flash_tc_head_shapes"):
        probe_flash_tc_head_shapes(gpu)
    if want("remat_step"):
        probe_remat_step(gpu)
    if want("ssm_cut_rounding"):
        probe_ssm_cut_rounding(gpu)
    return 0


PROBES = ("shared_loads", "fp32_issue", "wkv6_step_loop", "wkv6_per_step",
          "int_issue", "memory_in_flight", "decay_scan_tiles",
          "sha256_blocks", "flash_tiles", "flash_bwd_tiles",
          "flash_bwd_memory", "flash_tc_bwd_tiles", "merkle_units",
          "merkle_host",
          "profiler_count", "flash_tc_head_shapes", "remat_step",
          "ssm_cut_rounding")


def probe_flash_tc_head_shapes(gpu: str) -> None:
    """The tensor-core forward at head shapes no served path runs, timed
    as chip_smoke.py times the served ones (``_flash_timing``)."""
    import torch
    from chip_smoke import SERVE_BATCH, SERVE_PROMPT, _flash_timing
    gen = torch.Generator(device="cuda").manual_seed(20264)
    B, S = SERVE_BATCH, SERVE_PROMPT
    for name, (H, Kv, hd) in (("stablelm-3b heads at hd 80", (32, 32, 80)),
                              ("stablelm-3b heads at hd 128", (32, 32, 128)),
                              ("arctic-480b heads", (56, 8, 128))):
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, S, Kv, hd, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, S, Kv, hd, generator=gen, device="cuda").bfloat16()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa(qt=qt, kt=kt, vt=vt):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        emit({"probe": "flash_tc_head_shapes", "gpu": gpu, "case": name,
              "shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} bf16 causal",
              **_flash_timing(q, k, v, sdpa, S * (S + 1) // 2, causal=True)})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def probe_remat_step(gpu: str) -> None:
    """qwen3-0.6b's training step at the train CLI's batch, from its
    threefry init, with ``remat`` and without, in turns, by chip_smoke.py's
    ``step_split``."""
    import dataclasses
    from chip_smoke import step_split
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.train.steps import TrainHparams, make_train_state
    cfg = get_config("qwen3-0.6b")
    state = make_train_state(cfg, random.key(0), "cuda")
    batch = SyntheticTokenPipeline(cfg, InputShape("cli", 256, 32,
                                                   "train")).batch(0)
    hp = TrainHparams(peak_lr=3e-4, warmup_steps=5, total_steps=8)
    splits = {True: [], False: []}
    for remat in (True, False, False, True):
        splits[remat].append(step_split(
            dataclasses.replace(cfg, remat=remat), state, batch, hp, reps=3))
    emit({"probe": "remat_step", "gpu": gpu, "arch": cfg.name,
          "batch": "32 x 256 bf16", "config_remat": cfg.remat,
          "remat_on": splits[True], "remat_off": splits[False]})


def probe_ssm_cut_rounding(gpu: str) -> None:
    """The train_ssm cut's gradient (chip_smoke.py ``ssm_cut``,
    ``_grads_by_path``) in bf16 and float32 on the card and the CPU, from
    the state and batch its card trainer starts from; each pair's errors
    by chip_smoke.py's ``_leaf_errs``."""
    import dataclasses
    import time
    from chip_smoke import (CUT_BATCH, CUT_SEQ, _grads_by_path, _leaf_errs,
                            ssm_cut)
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.steps import make_train_state
    cut = ssm_cut(get_config("rwkv6-7b"))
    cut32 = dataclasses.replace(cut, dtype="float32")
    batch = SyntheticTokenPipeline(cut, InputShape("cli", CUT_SEQ, CUT_BATCH,
                                                   "train")).batch(0)
    card = make_train_state(cut, random.key(0), "cuda").params
    host = tree_map(lambda t: t.cpu(), card)
    grads, secs = {}, {}
    for name, cfg, params in (
            ("card bf16", cut, card), ("cpu bf16", cut, host),
            ("card float32", cut32, tree_map(lambda t: t.float(), card)),
            ("cpu float32", cut32, tree_map(lambda t: t.float(), host))):
        t = time.perf_counter()
        grads[name] = _grads_by_path(cfg, params, batch)
        secs[name] = time.perf_counter() - t
    pairs = {}
    for got, want in (("card bf16", "cpu bf16"), ("card float32",
                                                  "cpu float32"),
                      ("cpu bf16", "cpu float32"),
                      ("card bf16", "card float32"),
                      ("card bf16", "cpu float32")):
        errs = _leaf_errs(grads[got], grads[want])
        worst = max(errs, key=errs.get)
        pairs[f"{got} vs {want}"] = {"worst_leaf": worst,
                                     "worst": errs[worst], "by_leaf": errs}
    emit({"probe": "ssm_cut_rounding", "gpu": gpu,
          "cut": f"rwkv6-7b, {cut.n_layers} layers at full width, batch "
                 f"{CUT_BATCH} x {CUT_SEQ}, threefry key 0, batch 0",
          "seconds": secs, "pairs": pairs})


def probe_profiler_count(gpu: str) -> None:
    """Three SHA-256 calls traced by ``torch.profiler`` in 200 sessions of
    each of two windows, in turns: "tight" launches as soon as the session
    starts and stops as soon as the card has synchronised; "quiet" sleeps
    ``QUIET_S`` at both ends. A session is ok if it records exactly the
    three SHA-256 kernels."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import sha256
    msg = torch.randint(0, 2**32, (1 << 16, 2), dtype=torch.int64,
                        device="cuda")
    sha256.sha256_rows_cuda(msg, raw=True, bswap=True)
    torch.cuda.synchronize()
    res = {w: {"sessions": 0, "ok": 0, "kernels_when_not": []}
           for w in ("tight", "quiet")}
    for _ in range(200):
        for window, quiet in (("tight", 0.0), ("quiet", QUIET_S)):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(quiet)
                for _ in range(3):
                    sha256.sha256_rows_cuda(msg, raw=True, bswap=True)
                torch.cuda.synchronize()
                time.sleep(quiet)
            names = [e.name for e in prof.events()
                     if e.device_type.name == "CUDA"]
            r = res[window]
            r["sessions"] += 1
            if len(names) == 3 and all("sha256_rows_kernel" in n
                                       for n in names):
                r["ok"] += 1
            else:
                r["kernels_when_not"].append(len(names))
    emit({"probe": "profiler_count", "gpu": gpu, "quiet_s": QUIET_S, **res})


# the quiet time at each end of a profiled window that the card test and
# chip_smoke.py use
QUIET_S = 0.02


INT_OPS = {0: "LOP3", 1: "SHF", 2: "IADD3", 3: "IMAD", 4: "LOP3 + IMAD",
           5: "LOP3 + IADD3", 6: "SHF + IADD3"}


def probe_int_issue(probes, out, gpu: str, hz: float, sms: int) -> None:
    """Integer warp instructions a scheduler issues per cycle: 8 chains a
    thread, one block of 128 x warps threads an SM (warps a scheduler)."""
    iters, res = 20000, {}
    for op, label in INT_OPS.items():
        res[label] = {}
        for warps in (1, 2, 4):
            ms = elapsed_ms(lambda: _ok(probes.probe_int(
                op, out.data_ptr(), sms, 128 * warps, iters)))
            res[label][f"{warps} warp(s) a scheduler"] = \
                8 * iters * warps / (ms * 1e-3 * hz)
    text = sass_of(ROOT / "build" / "repro_torch_probes" / "libprobes.so")
    emit({"probe": "int_issue", "gpu": gpu, "clock_hz": hz,
          "warp_instructions_per_cycle_per_scheduler": res,
          "sass_opcodes": {INT_OPS[int(re.search(r"ILi(\d)E", k)[1])]: v
                           for k, v in opcodes(text, "intops").items()}})


def _ok(rc: int) -> None:
    if rc:
        raise RuntimeError(f"probe launch failed ({rc})")


def probe_memory(probes, gpu: str, sms: int) -> None:
    """Bandwidth (a and b read, h written) against the bytes of loads an SM
    keeps in flight, at the decay scan's size; and the blocks an SM gets
    from the one-thread-a-chain grid at recurrentgemma-2b's prefill."""
    import torch
    n4 = 8 * 4096 * 2560 // 4
    a, b, o = (torch.rand(n4 * 4, device="cuda") for _ in range(3))
    res = {}
    for k in (1, 2, 4, 8):
        for blocks_per_sm in (1, 2, 4, 8, 16):
            threads = 128
            ms = elapsed_ms(lambda: _ok(probes.probe_stream(
                k, a.data_ptr(), b.data_ptr(), o.data_ptr(), n4,
                sms * blocks_per_sm, threads)))
            in_flight = blocks_per_sm * threads * k * 32
            res[f"K={k} blocks/SM={blocks_per_sm}"] = {
                "load_bytes_in_flight_per_sm": in_flight,
                "gb_per_s": 3 * n4 * 16 / (ms * 1e-3) / 1e9}
    del a, b, o
    # the one-thread-a-chain decay-scan grid: B C / 64 blocks of 64
    blocks = 8 * 2560 // 64
    ids = torch.zeros(blocks, dtype=torch.int32, device="cuda")
    _ok(probes.probe_smid(ids.data_ptr(), blocks, 64))
    per_sm = collections.Counter(ids.tolist())
    hist = collections.Counter(per_sm.values())
    hist[0] = sms - len(per_sm)
    emit({"probe": "memory_in_flight", "gpu": gpu,
          "stream": "a, b float32 read and h written once, 3 x 335.5 MB",
          "bandwidth_by_loads_in_flight": res,
          "per_chain_grid": {
              "blocks": blocks, "threads": 64,
              "sms_by_blocks_on_them": {str(k): v for k, v in
                                        sorted(hist.items())},
              "busiest_sm_over_mean": max(per_sm.values())
              / (blocks / sms)}})


def build_variants(source: str, variants: dict, logs: dict = None) -> dict:
    """``csrc/<source>`` built once a variant with the variant's -D flags
    (all nvcc processes started together) into its own library under
    ``build/repro_torch_probes/``, loaded; the port's library is not
    touched. ``logs``, if given, gets each variant's nvcc output (ptxas's
    registers and spills)."""
    from repro_torch.kernels import native
    import hashlib
    out = ROOT / "build" / "repro_torch_probes"
    out.mkdir(parents=True, exist_ok=True)
    src = native.CSRC / source
    # a variant is named by its source (and the headers beside it) and
    # flags, and built once: a second run of a probe in one call reuses it
    text = b"".join(p.read_bytes() for p in [src, *sorted(
        native.CSRC.glob("*.cuh"))])
    libs = {label: out / "{}_{}.so".format(src.stem, hashlib.sha256(
        text + " ".join(native.NVCC_FLAGS + flags).encode()).hexdigest()[:12])
        for label, flags in variants.items()}
    procs = {label: subprocess.Popen(
        [native._nvcc(), *native.NVCC_FLAGS, *flags, "-shared", "-o",
         str(libs[label]), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for label, flags in variants.items()
        if not libs[label].with_suffix(".log").exists()}
    try:
        for label, proc in procs.items():
            text, _ = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {source} {label}:\n"
                                   f"{text}")
            libs[label].with_suffix(".log").write_text(text)
        for label in variants:
            if logs is not None:
                logs[label] = libs[label].with_suffix(".log").read_text()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {label: ctypes.CDLL(str(lib)) for label, lib in libs.items()}


def probe_decay_tiles(gpu: str) -> None:
    """The tiled decay-scan kernel over tile shapes (steps x channels, each
    built from decay_scan.cu at -D DECAY_STEPS and DECAY_WARPS) and the
    port's one-thread-a-chain kernel at recurrentgemma-2b's prefill, (8,
    4096, 2560) from h0, in turns (events around 5 launches, median of
    3)."""
    import torch
    from repro_torch.kernels import decay_scan
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    tiles = [(steps, warps) for steps in (32, 64, 128, 256)
             for warps in (1, 2, 4) if 2 * steps * 32 * warps * 4
             <= 200 * 1024]
    libs = build_variants("decay_scan.cu", {
        f"{steps} steps x {32 * warps} channels":
            [f"-DDECAY_STEPS={steps}", f"-DDECAY_WARPS={warps}"]
        for steps, warps in tiles})
    gen = torch.Generator(device="cuda").manual_seed(16)
    B, S, C = 8, 4096, 2560
    a = torch.rand((B, S, C), generator=gen, device="cuda") * 0.7 + 0.3
    b = torch.randn((B, S, C), generator=gen, device="cuda")
    h0 = torch.randn((B, C), generator=gen, device="cuda")
    want = decay_scan.decay_scan_cuda_per_chain(a, b, h0)
    got = (torch.empty_like(a), torch.empty_like(h0))
    fns = {"per_chain": lambda: decay_scan.decay_scan_cuda_per_chain(
        a, b, h0)}
    for label, lib in libs.items():
        lib.pnp_decay_scan.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, vp,
                                       vp]
        lib.pnp_decay_scan.restype = ctypes.c_int
        lib.pnp_decay_scan_workspace_words.argtypes = [i64, i64]
        lib.pnp_decay_scan_workspace_words.restype = i64
        ws = torch.zeros(lib.pnp_decay_scan_workspace_words(B, C),
                         dtype=torch.int64, device="cuda")

        def call(lib=lib, ws=ws):
            _ok(lib.pnp_decay_scan(
                a.data_ptr(), b.data_ptr(), h0.data_ptr(), got[0].data_ptr(),
                got[1].data_ptr(), B, S, C, ws.data_ptr(),
                torch.cuda.current_stream().cuda_stream))
        call()
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise RuntimeError(f"tiled decay scan {label} differs from the "
                               "per-chain kernel")
        fns[label] = call
    del want
    times = {k: [] for k in fns}
    for r in range(2):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[k].append(elapsed_ms(lambda: [fns[k]() for _ in range(5)])
                            / 5)
    nbytes = 4 * (3 * a.numel() + 2 * h0.numel())
    emit({"probe": "decay_scan_tiles", "gpu": gpu,
          "shape": f"B={B} S={S} C={C} float32, h0", "bytes": nbytes,
          "equal_bits_to_per_chain": True,
          "ms": {k: statistics.median(v) for k, v in times.items()},
          "gb_per_s": {k: nbytes / (statistics.median(v) * 1e-3) / 1e9
                       for k, v in times.items()}})


def probe_sha_blocks(gpu: str) -> None:
    """The SHA-256 kernel at the mining path's shapes over threads a block,
    with and without the instances that fix W = 2 and 8 (each built from
    sha256.cu at -D SHA_THREADS and SHA_FIXED_W), each replayed from a CUDA
    graph of 10 launches (the card's time), and the port's SHA-256
    kernels' opcodes."""
    import torch
    from repro_torch.kernels import native, ref
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    blocks = [(threads, fixed) for threads in (64, 128, 256, 512)
              for fixed in (1, 0)]
    libs = build_variants("sha256.cu", {
        f"{threads} threads" + (", W fixed" if fixed else ""):
            [f"-DSHA_THREADS={threads}", f"-DSHA_FIXED_W={fixed}"]
        for threads, fixed in blocks})
    for lib in libs.values():
        lib.pnp_sha256_rows.argtypes = [vp, i64, i32, vp, vp, i32, vp]
        lib.pnp_sha256_rows.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(17)
    shapes = {"full chunk 2^16 x 2, both": (1 << 16, 2, True, True),
              "classic 2^20 x 2, raw": (1 << 20, 2, True, False),
              "classic 2^20 x 8, raw": (1 << 20, 8, True, False)}
    res = {}
    for label, (n, w, raw, bswap) in shapes.items():
        msg = torch.randint(0, 2**32, (n, w), generator=gen, device="cuda",
                            dtype=torch.int64)
        want = ref.sha256_words_ref(msg)
        outs = torch.empty((2, n, 8), dtype=torch.int64, device="cuda")
        res[label] = {}
        for variant, lib in libs.items():
            def call(lib=lib):
                _ok(lib.pnp_sha256_rows(
                    msg.data_ptr(), n, w, outs[0].data_ptr() if raw else None,
                    outs[1].data_ptr() if bswap else None, 0,
                    torch.cuda.current_stream().cuda_stream))
            call()
            if not torch.equal(outs[0], want):
                raise RuntimeError(f"sha256 {label} {variant}")
            res[label][variant] = graph_ms(call)
        del msg, want, outs
    lib, _ = native.build()
    emit({"probe": "sha256_blocks", "gpu": gpu,
          "device_ms_from_graph": res,
          "sass_opcodes": opcodes(sass_of(lib), "sha256_rows_kernel")})


def graph_ms(fn, reps: int = 10) -> float:
    """``reps`` calls captured in a CUDA graph; its replay's median time
    (``elapsed_ms``) over ``reps``."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return elapsed_ms(graph.replay) / reps


def probe_flash_tiles(gpu: str) -> None:
    """The CUDA-core flash kernel, float32, causal, over tiles (each built
    from flash_attention.cu at -D FLASH_WARPS, FLASH_BK and FLASH_STAGES),
    each within 2e-4 of the plain version and equal from launch to launch:
    at qwen3-0.6b's prefill shape by events around 10 launches, in turns
    with SDPA's efficient backend (K and V repeated to H heads, TF32 off);
    at pnpcoin-demo's shape replayed from a CUDA graph."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ref
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    tiles = [(8, 64, 1), (8, 128, 1), (4, 128, 1), (4, 64, 1), (4, 64, 2),
             (4, 32, 1), (4, 32, 2), (8, 32, 1)]
    libs = build_variants("flash_attention.cu", {
        f"{w} warps x {bk} keys x {st} stages":
            [f"-DFLASH_WARPS={w}", f"-DFLASH_BK={bk}",
             f"-DFLASH_STAGES={st}"] for w, bk, st in tiles})
    for lib in libs.values():
        lib.pnp_flash_attention_fwd.argtypes = [
            vp, vp, vp, vp, i64, i64, i64, i32, i32, i32, i32, i32, i32, vp]
        lib.pnp_flash_attention_fwd.restype = ctypes.c_int
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(18)
    res = {}
    for shape, (B, S, H, Kv, hd) in {
            "qwen3-0.6b": (8, 2048, 16, 8, 128),
            "pnpcoin-demo": (8, 32, 8, 4, 32)}.items():
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda")
        k = torch.randn(B, S, Kv, hd, generator=gen, device="cuda")
        v = torch.randn(B, S, Kv, hd, generator=gen, device="cuda")
        want = ref.flash_attention_ref(q, k, v, causal=True)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.repeat_interleave(H // Kv, dim=2).transpose(1, 2)
                  .contiguous() for x in (k, v))
        out = torch.empty_like(q)

        def sdpa():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)
        fns = {"sdpa_efficient": sdpa}
        for label, lib in libs.items():
            def call(lib=lib):
                _ok(lib.pnp_flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, S, H, Kv, hd, 1, 0, 0,
                    torch.cuda.current_stream().cuda_stream))
            call()
            first = out.clone()
            call()
            if not (torch.allclose(out, want, rtol=2e-4, atol=2e-4)
                    and torch.equal(out, first)):
                raise RuntimeError(f"flash {label} at {shape}: "
                                   f"{float((out - want).abs().max())}")
            fns[label] = call
        if S > 64:
            times = {key: [] for key in fns}
            for r in range(2):
                for key in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                    times[key].append(elapsed_ms(
                        lambda: [fns[key]() for _ in range(10)]) / 10)
            ms = {key: statistics.median(t) for key, t in times.items()}
        else:
            ms = {key: graph_ms(fn) for key, fn in fns.items()}
        res[shape] = {"shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} "
                               "float32 causal",
                      "timed": "events, 10 launches, in turns" if S > 64
                      else "from a CUDA graph", "ms": ms}
        del q, k, v, want, qt, kt, vt, out
        torch.cuda.empty_cache()
    emit({"probe": "flash_tiles", "gpu": gpu, **res})


# the backward's variants: label -> -D flags. The key pass's tile is
# (BWD_DKV_WARPS, BWD_DKV_TM, BWD_DKV_BQ, BWD_DKV_STAGES), the dQ pass's
# ring BWD_DQS_STAGES. A flag set applies to every head dim; one left out
# keeps the source's tile
def _bwd_flags(dkv=None, dqs_stages=None):
    flags = []
    if dkv:
        flags += [f"-DBWD_DKV_{n}={x}" for n, x in
                  zip(("WARPS", "TM", "BQ", "STAGES"), dkv)]
    if dqs_stages:
        flags += [f"-DBWD_DQS_STAGES={dqs_stages}"]
    return flags


BWD_VARIANTS = {
    "the source's tiles": [],
    "dq ring x 3": _bwd_flags(dqs_stages=3),
    "dkv 8w x 8 keys x 32 queries x 2": _bwd_flags(dkv=(8, 8, 32, 2)),
    "dkv 8w x 4 keys x 64 queries x 2": _bwd_flags(dkv=(8, 4, 64, 2)),
    "small: dkv 1w x 16 keys x 32 queries": _bwd_flags(dkv=(1, 16, 32, 2)),
    "small: dkv 4w x 8 keys x 32 queries": _bwd_flags(dkv=(4, 8, 32, 2)),
}
BWD_KERNELS = r"(dq_kernel|dkv_kernel|dot_kernel)"
# |kernel - twin| <= BWD_TOL max(1, max |twin|), as chip_smoke.py holds it
BWD_TOL = 1e-5


def ptxas_kernels(log: str, pattern: str) -> dict:
    """Registers and spill lines of each kernel whose mangled name matches
    ``pattern`` (a regex with the name in group 1), by name and head dim,
    from nvcc's ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            found = re.search(pattern, entry[1])
            hd = re.search(r"ILi(\d+)E", entry[1])
            name = f"{found[1]}<hd={hd[1]}>" if found and hd else None
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def kernel_split(fn, calls: int = 5, pattern: str = BWD_KERNELS) -> dict:
    """Device ms and launches a call of each CUDA kernel ``fn`` launches,
    by ``torch.profiler`` over ``calls`` calls (quiet time at both ends);
    kernels named by ``pattern``'s group 1 where it matches."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(QUIET_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(QUIET_S)
    ms, n = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type.name == "CUDA":
            found = re.search(pattern, e.name)
            name = found[1] if found else e.name[:40]
            ms[name] += e.device_time / 1e3 / calls
            n[name] += 1
    return {name: {"ms": ms[name], "launches": n[name] / calls}
            for name in ms}


def probe_flash_bwd_tiles(gpu: str) -> None:
    """The float32 flash backward over ``BWD_VARIANTS`` (each built from
    flash_attention_bwd.cu with its -D flags), causal, each within
    ``BWD_TOL`` of the plain twin and bit-equal from launch to launch: at
    qwen3-0.6b's prefill shape by events around 10 calls, in turns with
    SDPA's efficient backward (K and V repeated to H heads, TF32 off); at
    pnpcoin-demo's training call replayed from a CUDA graph, SDPA's too.
    Each variant's registers and spills from ptxas."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from chip_smoke import sdpa_backward_graph_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ref
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    logs = {}
    libs = build_variants("flash_attention_bwd.cu", BWD_VARIANTS, logs)
    for lib in libs.values():
        lib.pnp_flash_attention_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i64, i32, i32,
            i32, i32, i32, i64, vp]
        lib.pnp_flash_attention_bwd.restype = ctypes.c_int
        lib.pnp_flash_attention_bwd_workspace_words.argtypes = [
            i64, i64, i64, i32, i32, i32, i32, i64]
        lib.pnp_flash_attention_bwd_workspace_words.restype = ctypes.c_int64
    emit({"probe": "flash_bwd_tiles", "gpu": gpu, "flags": BWD_VARIANTS,
          "ptxas": {label: ptxas_kernels(
              text, BWD_KERNELS)
              for label, text in logs.items()}})
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(20)
    for shape, (B, S, H, Kv, hd) in {
            "qwen3-0.6b": (8, 2048, 16, 8, 128),
            "pnpcoin-demo": (4, 32, 8, 4, 32)}.items():
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda")
        k = torch.randn(B, S, Kv, hd, generator=gen, device="cuda")
        v = torch.randn(B, S, Kv, hd, generator=gen, device="cuda")
        o, lse = fa.flash_attention_lse_cuda(q, k, v, causal=True)
        do = torch.randn(o.shape, generator=gen, device="cuda")
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
        scales = [max(1.0, float(w.abs().max())) for w in want]
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (x.repeat_interleave(H // Kv, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for x in (k, v))
        dot = do.transpose(1, 2).contiguous()
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sd_out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)

        def sdpa():
            return torch.autograd.grad(sd_out, (qt, kt, vt), dot,
                                       retain_graph=True)
        fns, errs = {"sdpa_efficient": sdpa}, {}
        outs = [torch.empty_like(x) for x in (q, k, v)]
        for label, lib in libs.items():
            ws = torch.empty(lib.pnp_flash_attention_bwd_workspace_words(
                B, S, S, H, hd, 1, 0, fb.DS_CAP_BYTES), dtype=torch.int32,
                device="cuda")

            def call(lib=lib, ws=ws):
                _ok(lib.pnp_flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), do.data_ptr(), outs[0].data_ptr(),
                    outs[1].data_ptr(), outs[2].data_ptr(), ws.data_ptr(),
                    B, S, S, H, Kv, hd, 1, 0, fb.DS_CAP_BYTES,
                    torch.cuda.current_stream().cuda_stream))
            call()
            first = [x.clone() for x in outs]
            call()
            err = [float((g - w).abs().max()) for g, w in zip(outs, want)]
            if not all(torch.equal(a, b) for a, b in zip(outs, first)):
                raise RuntimeError(f"flash backward {label} at {shape}: two "
                                   "launches differ")
            if any(e > BWD_TOL * sc for e, sc in zip(err, scales)):
                raise RuntimeError(f"flash backward {label} at {shape}: "
                                   f"{err} against {scales}")
            errs[label] = max(e / sc for e, sc in zip(err, scales))
            fns[label] = call
            del first
        if S > 64:
            times = {key: [] for key in fns}
            for r in range(2):
                for key in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                    times[key].append(elapsed_ms(
                        lambda: [fns[key]() for _ in range(10)]) / 10)
            ms = {key: statistics.median(t) for key, t in times.items()}
        else:
            ms = {key: graph_ms(fn) for key, fn in fns.items()
                  if key != "sdpa_efficient"}
            ms["sdpa_efficient"] = sdpa_backward_graph_ms(qt, kt, vt, dot)
        split = kernel_split(fns[next(iter(BWD_VARIANTS))])
        emit({"probe": "flash_bwd_tiles", "gpu": gpu, "at": shape,
              "shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} float32 "
                       "causal",
              "timed": "events, 10 calls, in turns" if S > 64
              else "from a CUDA graph", "ms": ms,
              "source_tiles_by_kernel": split,
              "tolerance": f"max |kernel - twin| <= {BWD_TOL} max(1, max "
                           "|twin|), each of dQ, dK, dV",
              "max_err_over_scale": errs})
        del q, k, v, o, lse, do, want, qt, kt, vt, dot, sd_out, outs
        torch.cuda.empty_cache()


# the backward's memory probe: (B, S, H, Kv, hd), causal; the second holds
# 4.3 GB of dS, past the wrapper's 2 GiB cap
BWD_MEMORY_SHAPES = {"qwen3-0.6b": (8, 2048, 16, 8, 128),
                     "S=T=4096": (8, 4096, 16, 8, 128)}


def probe_flash_bwd_memory(gpu: str) -> None:
    """The most device memory a float32 flash backward call allocates over
    its inputs (its outputs and workspace, by the allocator's peak), for
    the tree whose ``repro_torch`` is imported (this one, or ``--src``'s),
    at ``BWD_MEMORY_SHAPES``; SDPA's efficient backward beside it (its K
    and V repeated to H heads, so its dK and dV are G times the kernel's).
    Where the tree's wrapper caps dS (``DS_CAP_BYTES``), also each shape
    with that cap and in one chunk: their workspaces, kernel launches a
    call, times by events around 5 calls in turns, and the largest
    difference between the two (the chunks change the order of dQ's
    sum)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import repro_torch
    from chip_smoke import peak_extra_bytes
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import native
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(21)
    for shape, (B, S, H, Kv, hd) in BWD_MEMORY_SHAPES.items():
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda")
        k = torch.randn(B, S, Kv, hd, generator=gen, device="cuda")
        v = torch.randn(B, S, Kv, hd, generator=gen, device="cuda")
        o, lse = fa.flash_attention_lse_cuda(q, k, v, causal=True)
        do = torch.randn(o.shape, generator=gen, device="cuda")
        outputs = 4 * (q.numel() + 2 * k.numel())
        kernel = peak_extra_bytes(lambda: fb.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=True))
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (x.repeat_interleave(H // Kv, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for x in (k, v))
        dot = do.transpose(1, 2).contiguous()
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sd_out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
        sdpa = peak_extra_bytes(lambda: torch.autograd.grad(
            sd_out, (qt, kt, vt), dot, retain_graph=True))
        entry = {"probe": "flash_bwd_memory", "gpu": gpu,
                 "tree": str(Path(repro_torch.__file__).resolve()
                             .parents[2]), "at": shape,
                 "shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} float32 "
                          "causal",
                 "kernel_peak_bytes": kernel,
                 "kernel_outputs_bytes": outputs,
                 "kernel_workspace_bytes": kernel - outputs,
                 "sdpa_efficient_peak_bytes": sdpa}
        del qt, kt, vt, dot, sd_out
        torch.cuda.empty_cache()
        if hasattr(fb, "DS_CAP_BYTES"):
            lib = native.library()
            outs = [torch.empty_like(x) for x in (q, k, v)]
            fns, got, ws_bytes = {}, {}, {}
            for label, cap in (("capped", fb.DS_CAP_BYTES),
                               ("one_chunk", 1 << 40)):
                ws = torch.empty(lib.pnp_flash_attention_bwd_workspace_words(
                    B, S, S, H, hd, 1, 0, cap), dtype=torch.int32,
                    device="cuda")

                def call(ws=ws, cap=cap):
                    _ok(lib.pnp_flash_attention_bwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                        outs[0].data_ptr(), outs[1].data_ptr(),
                        outs[2].data_ptr(), ws.data_ptr(), B, S, S, H, Kv,
                        hd, 1, 0, cap,
                        torch.cuda.current_stream().cuda_stream))
                call()
                got[label] = [x.clone() for x in outs]
                fns[label] = call
                ws_bytes[label] = 4 * ws.numel()
            times = {key: [] for key in fns}
            for r in range(2):
                for key in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                    times[key].append(elapsed_ms(
                        lambda: [fns[key]() for _ in range(5)]) / 5)
            entry["cap_bytes"] = fb.DS_CAP_BYTES
            entry["workspace_bytes"] = ws_bytes
            entry["launches_a_call"] = {
                key: {name: x["launches"] for name, x in
                      kernel_split(fn, calls=1).items()}
                for key, fn in fns.items()}
            entry["ms_by_events_in_turns"] = {
                key: statistics.median(t) for key, t in times.items()}
            entry["capped_vs_one_chunk_max_abs_diff"] = [
                float((a - b).abs().max())
                for a, b in zip(got["capped"], got["one_chunk"])]
            del outs, fns, got, ws, call
        emit(entry)
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()


# the bf16 backward's variants: label -> -D flags of
# flash_attention_tc_bwd.cu: consumer warpgroups a block (so keys of a dK/dV
# item and query rows of a dQ item: 64 each), stages of the streamed ring,
# resident buffers, and the registers `setmaxnreg` leaves the producer (the
# consumers get the rest). The first is the source's tile
def _tc_bwd_flags(consumers, stages, buffers, producer_regs):
    return [f"-DBWD_TC_CONSUMERS={consumers}", f"-DBWD_TC_STAGES={stages}",
            f"-DBWD_TC_RES_BUFS={buffers}",
            f"-DBWD_TC_PRODUCER_REGS={producer_regs}"]


TC_BWD_VARIANTS = {
    f"{64 * nc} keys, {st} stages, {rb} buffer{'s' * (rb > 1)}, producer "
    f"{pr}": _tc_bwd_flags(nc, st, rb, pr)
    for nc, st, rb, pr in ((2, 3, 1, 24), (2, 2, 2, 24), (2, 4, 1, 24),
                           (2, 3, 1, 40), (1, 2, 1, 24))}
# the bf16 backward's kernels, this tree's and (for --src) the two-pass
# design's before it
TC_BWD_KERNELS = r"(tc_bwd_kernel|tc_dkv_kernel|tc_dq_kernel|tc_dot_kernel)"
# the bf16 backward's shapes, causal: (B, S, H, Kv, hd)
TC_BWD_SHAPES = {"train_cli": (32, 256, 16, 8, 128),
                 "qwen3-0.6b prefill": (8, 2048, 16, 8, 128)}


def probe_flash_tc_bwd_tiles(gpu: str) -> None:
    """The bf16 backward at ``TC_BWD_SHAPES`` (causal), each call held
    against the plain twin within chip_smoke.py's ``TC_BWD_TOL`` and
    bit-equal from launch to launch: the imported tree's wrapper (this one,
    or ``--src``'s) and, for this tree, each of ``TC_BWD_VARIANTS`` (built
    from flash_attention_tc_bwd.cu with its -D flags), by events around 10
    calls in turns with SDPA's bf16 backward (its default backend, K and V
    repeated to H heads) and replayed from a CUDA graph (SDPA's too); the
    wrapper's split by kernel (``torch.profiler``) and its peak device
    memory over its inputs; each variant's ptxas registers and spills."""
    import torch
    import repro_torch
    from chip_smoke import (TC_BWD_TOL, peak_extra_bytes,
                            sdpa_backward_graph_ms)
    from repro_torch.kernels import flash_attention_tc as ft
    from repro_torch.kernels import flash_attention_tc_bwd as ftb
    from repro_torch.kernels import ref
    tree = str(Path(repro_torch.__file__).resolve().parents[2])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    sweep = not any(a.startswith("--src=") for a in sys.argv)
    logs, libs = {}, {}
    if sweep:
        libs = build_variants("flash_attention_tc_bwd.cu", TC_BWD_VARIANTS,
                              logs)
        for lib in libs.values():
            lib.pnp_flash_attention_tc_bwd.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i64,
                i64, i32, i32, i32, i32, i32, vp]
            lib.pnp_flash_attention_tc_bwd.restype = ctypes.c_int
            lib.pnp_flash_attention_tc_bwd_info.argtypes = [i32, vp]
            lib.pnp_flash_attention_tc_bwd_info.restype = ctypes.c_int
        emit({"probe": "flash_tc_bwd_tiles", "gpu": gpu, "tree": tree,
              "flags": TC_BWD_VARIANTS,
              "ptxas": {label: ptxas_kernels(text, TC_BWD_KERNELS)
                        for label, text in logs.items()},
              "ptxas_performance_notes": {
                  label: [line.strip()[:160] for line in text.splitlines()
                          if re.search(r"\(C7\d\d\d\)", line)]
                  for label, text in logs.items()}})
    gen = torch.Generator(device="cuda").manual_seed(22)
    for shape, (B, S, H, Kv, hd) in TC_BWD_SHAPES.items():
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, S, Kv, hd, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, S, Kv, hd, generator=gen, device="cuda").bfloat16()
        o, lse = ft.flash_attention_tc_lse_cuda(q, k, v, causal=True)
        do = torch.randn(o.shape, generator=gen, device="cuda").bfloat16()
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
        scales = [max(1.0, float(w.abs().max())) for w in want]
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (x.repeat_interleave(H // Kv, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for x in (k, v))
        dot = do.transpose(1, 2).contiguous()
        sd_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)

        def sdpa():
            return torch.autograd.grad(sd_out, (qt, kt, vt), dot,
                                       retain_graph=True)

        def wrapper():
            return ftb.flash_attention_tc_bwd_cuda(q, k, v, o, lse, do,
                                                   causal=True)
        fns, errs = {"sdpa": sdpa, "wrapper": wrapper}, {}
        outs = [torch.empty_like(x) for x in (q, k, v)]
        for label, lib in libs.items():
            info = (ctypes.c_int32 * 11)()
            _ok(lib.pnp_flash_attention_tc_bwd_info(hd, info))
            rows = info[0]
            items = torch.from_numpy(ftb.schedule(
                B, S, S, H, Kv, True, 0, rows)).cuda()
            ws = torch.empty((2, B, H, -(-S // rows) * rows),
                             dtype=torch.float32, device="cuda")

            def call(lib=lib, items=items, ws=ws):
                _ok(lib.pnp_flash_attention_tc_bwd(
                    *(t.data_ptr() for t in (q, k, v, o, lse, do, *outs,
                                             ws[0], ws[1], items)),
                    items.shape[0], B, S, S, H, Kv, hd, 1, 0,
                    torch.cuda.current_stream().cuda_stream))
                return outs
            fns[label] = call
        wrong = {}
        for label, fn in list(fns.items())[1:]:
            first = [x.clone() for x in fn()]
            got = fn()
            err = [float((g.float() - w.bfloat16().float()).abs().max())
                   for g, w in zip(got, want)]
            if not all(torch.equal(a, b) for a, b in zip(got, first)):
                wrong[label] = "two launches differ"
            elif any(e > TC_BWD_TOL * sc for e, sc in zip(err, scales)):
                wrong[label] = f"{err} against {scales}"
            errs[label] = max(e / sc for e, sc in zip(err, scales))
            del first, got
        if "wrapper" in wrong:
            raise RuntimeError(f"bf16 backward at {shape}: {wrong}")
        # a variant that is wrong is reported and not timed
        for label in wrong:
            del fns[label]
        times = {key: [] for key in fns}
        for r in range(2):
            for key in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                times[key].append(elapsed_ms(
                    lambda: [fns[key]() for _ in range(10)]) / 10)
        graph = {key: graph_ms(fn) for key, fn in fns.items()
                 if key != "sdpa"}
        graph["sdpa"] = sdpa_backward_graph_ms(qt, kt, vt, dot, backend=None)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        emit({"probe": "flash_tc_bwd_tiles", "gpu": gpu, "tree": tree,
              "at": shape, "clocks_power_temperature_after": smi,
              "shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} bf16 causal",
              "ms_by_events_in_turns": {key: statistics.median(t)
                                        for key, t in times.items()},
              "ms_from_graph": graph,
              "wrapper_by_kernel": kernel_split(wrapper,
                                                pattern=TC_BWD_KERNELS),
              "wrapper_peak_bytes_over_inputs": peak_extra_bytes(wrapper),
              "sdpa_peak_bytes_over_inputs": peak_extra_bytes(sdpa),
              "tolerance": f"max |kernel - twin| <= {TC_BWD_TOL} max(1, max "
                           "|twin|), each of dQ, dK, dV",
              "max_err_over_scale": errs, "wrong_variants": wrong})
        del q, k, v, o, lse, do, want, qt, kt, vt, dot, sd_out, outs, fns
        torch.cuda.empty_cache()


def probe_merkle_units(gpu: str) -> None:
    """The Merkle reduction over the nodes a block takes in and the levels
    it reduces them through (each built from merkle.cu at -D
    MERKLE_LOG_UNIT and MERKLE_SPAN), equal to the port's kernel, at 2**20
    leaves (one tree) and 4 trees of 2**16, from a CUDA graph of 10
    launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import merkle
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    units = [(10, 10), (10, 6), (10, 5), (10, 4), (9, 9), (9, 5), (8, 8),
             (8, 4)]
    libs = build_variants("merkle.cu", {
        f"{1 << u} nodes a unit, {span} levels": [
            f"-DMERKLE_LOG_UNIT={u}", f"-DMERKLE_SPAN={span}"]
        for u, span in units})
    for lib in libs.values():
        lib.pnp_merkle_reduce.argtypes = [vp, i64, i64, i64, i32, vp, vp,
                                          vp, i32, vp]
        lib.pnp_merkle_reduce.restype = ctypes.c_int
        lib.pnp_merkle_workspace_words.argtypes = [i64, i64, i64, i32]
        lib.pnp_merkle_workspace_words.restype = i64
    rng = np.random.RandomState(19)
    res = {}
    for shape, (B, n) in {"2^20 leaves": (1, 1 << 20),
                          "4 trees x 2^16": (4, 1 << 16)}.items():
        d = merkle._to_device(rng.randint(0, 2**32, (B, n, 8),
                                          dtype=np.uint64)
                              .astype(np.uint32), "cuda")
        want = merkle.merkle_reduce(d)[-1]
        out = torch.empty_like(want)
        res[shape] = {}
        for label, lib in libs.items():
            counters, nodes = (torch.zeros(
                max(1, lib.pnp_merkle_workspace_words(B, n, merkle._CUTOVER,
                                                      c)),
                dtype=torch.int32, device="cuda") for c in (1, 0))

            def call(lib=lib, counters=counters, nodes=nodes):
                _ok(lib.pnp_merkle_reduce(
                    d.data_ptr(), B, n, merkle._CUTOVER, 0, out.data_ptr(),
                    counters.data_ptr(), nodes.data_ptr(), -1,
                    torch.cuda.current_stream().cuda_stream))
            call()
            if not torch.equal(out, want):
                raise RuntimeError(f"merkle {label} at {shape}")
            res[shape][label] = graph_ms(call)
    emit({"probe": "merkle_units", "gpu": gpu,
          "device_ms_from_graph": res})


def probe_merkle_host(gpu: str) -> None:
    """Host clock, synchronised, of a 2**20-leaf full result's
    ``commit_root()`` (median of 5) and its steps, and of
    ``recompute_roots_batched`` on it (median of 3), for the tree whose
    ``repro_torch`` is imported (this one, or ``--src``'s). Its steps
    follow that tree's Merkle module: the numpy view (or the transpose and
    widening of the per-level module), the copy to the card, the
    reduction, the copy back and the hashlib top."""
    import time

    import numpy as np
    import torch
    import repro_torch
    from repro_torch.core.executor import run_full
    from repro_torch.core.jash import Jash, JashMeta, collatz_jash
    from repro_torch.core.verify import recompute_roots_batched
    from repro_torch.kernels import merkle
    base = collatz_jash(max_steps=512)
    job = Jash(base.name, base.fn, JashMeta(arg_bits=20, res_bits=32,
                                            importance=0.8),
               example_args=base.example_args)
    full = run_full(job, device="cuda")
    dev = full.device

    def split():
        t = [time.perf_counter()]
        d = full.leaf_digests[None]
        if hasattr(merkle, "merkle_reduce"):      # one launch a reduction
            x = torch.from_numpy(np.ascontiguousarray(
                d, dtype=np.uint32).view(np.int32))
        else:                                     # one launch a level
            x = torch.from_numpy(np.ascontiguousarray(
                np.asarray(d, np.uint32).transpose(2, 0, 1))
                .astype(np.int64))
        t.append(time.perf_counter())
        x = x.to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        top = merkle.merkle_reduce(x)[-1] \
            if hasattr(merkle, "merkle_reduce") else merkle._reduce(x, False)[-1]
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        top = merkle._to_host(top)[0]
        t.append(time.perf_counter())
        root = merkle._host_levels(merkle._words_to_digest_list(top))[-1][0]
        t.append(time.perf_counter())
        return root.hex(), [b - a for a, b in zip(t, t[1:])]

    def clock(fn, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return out, statistics.median(times)

    root, total = clock(full.commit_root, 5)
    parts = [split() for _ in range(5)]
    if any(r != root for r, _ in parts):
        raise RuntimeError("commit_root's steps give another root")
    roots, verify_s = clock(
        lambda: recompute_roots_batched([full], device=dev), 3)
    if roots != [root]:
        raise RuntimeError("recompute_roots_batched gives another root")
    steps = ("prepare_s", "copy_to_card_s", "reduce_s", "copy_back_s",
             "hashlib_top_s")
    emit({"probe": "merkle_host", "gpu": gpu,
          "tree": str(Path(repro_torch.__file__).resolve().parents[2]),
          "root": root, "commit_root_s": total,
          "commit_root_split_s": {
              k: statistics.median(p[i] for _, p in parts)
              for i, k in enumerate(steps)},
          "recompute_roots_batched_s": verify_s})


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        if arg.startswith("--src="):
            sys.path.insert(0, str(Path(arg.split("=", 1)[1]).resolve()
                                   / "src"))
    sys.exit(main())
