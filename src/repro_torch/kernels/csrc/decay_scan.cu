// Gated linear decay scan h_t = a_t * h_{t-1} + b_t (the RG-LRU inner
// recurrence), one launch for a whole sequence.
//
// Replaces: src/repro/kernels/decay_scan.py `_decay_scan_kernel` /
// `decay_scan_pallas` (reached through `ops.decay_scan`), whose function is
// the `associative_scan` inside `repro.models.rglru.rg_lru_scan`: every
// RG-LRU layer of a recurrentgemma prefill computes it.
//
// a, b, out (B, S, C) and h0, h_last (B, C), float32, contiguous; h0 may be
// null (a zero start). h0 enters as h_{-1}, so h_0 = a_0 h0 + b_0 (the
// reference folds a_0 h0 into b_0 first: the same value, rounded once less).
//
// What bounds it on an H100: bytes. Two flops per element against 12
// bytes (a and b read, h written): at (8, 4096, 2560) that is 1.01 GB,
// 0.30 ms at 3.35 TB/s. But each channel's steps are sequential, so only
// B x C = 20,480 chains run at once, too few to cover the memory latency
// with one load in flight each.
//
// What the design does about it:
// - one thread per (b, c), looping over t; a warp reads 32 neighbouring
//   channels of one step, so every load and store is coalesced and no
//   padding of C is needed (the TPU kernel's 128-channel tiles are a lane
//   width there);
// - the loop loads UNROLL = 16 steps of a and b into registers before it
//   uses them, so each thread keeps 32 loads in flight;
// - 64 threads a block, so the 20,480 chains spread over 320 blocks and
//   every SM gets work;
// - each h_t depends on the one before only: the result repeats bit for
//   bit from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
decay_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  float* __restrict__ h_last, int64_t S, int64_t C,
                  int64_t BC) {
    const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= BC) return;
    const int64_t bi = idx / C, c = idx % C;
    const size_t base = (size_t)bi * S * C + c;
    float h = h0 ? h0[idx] : 0.f;
    int64_t t = 0;
    for (; t + UNROLL <= S; t += UNROLL) {
        float av[UNROLL], bv[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            av[j] = __ldg(a + base + (size_t)(t + j) * C);
            bv[j] = __ldg(b + base + (size_t)(t + j) * C);
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            h = fmaf(av[j], h, bv[j]);
            out[base + (size_t)(t + j) * C] = h;
        }
    }
    for (; t < S; ++t) {
        h = fmaf(__ldg(a + base + (size_t)t * C), h,
                 __ldg(b + base + (size_t)t * C));
        out[base + (size_t)t * C] = h;
    }
    h_last[idx] = h;
}

}  // namespace

// a, b, out: (B, S, C); h0 (or null), h_last: (B, C); float32, contiguous.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int pnp_decay_scan(const void* a, const void* b, const void* h0,
                              void* out, void* h_last, int64_t B, int64_t S,
                              int64_t C, void* stream) {
    if (B < 0 || S < 0 || C < 0) return (int)cudaErrorInvalidValue;
    const int64_t BC = B * C;
    if (BC == 0) return 0;
    const int64_t blocks = (BC + THREADS - 1) / THREADS;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    decay_scan_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const float*)h0, (float*)out,
        (float*)h_last, S, C, BC);
    return (int)cudaGetLastError();
}
