// Backward of the gated linear decay scan h_t = a_t * h_{t-1} + b_t (the
// RG-LRU inner recurrence, decay_scan.cu), one launch for a whole sequence.
//
// Replaces no TPU kernel on its own: the reference has no Pallas backward
// (jax.grad differentiates the `associative_scan` of
// repro.models.rglru.rg_lru_scan, the function of
// src/repro/kernels/decay_scan.py `_decay_scan_kernel`). The port's training
// step reaches it through kernels/decay_scan.py's autograd Function, once a
// recurrent layer and step.
//
// a, h, dh, da, db (B, S, C); dh_last, h0, dh0 (B, C); float32, contiguous.
// h is the forward's output (h_t), h0 its start (null: zeros), dh_last the
// gradient of the forward's h_last (null: zeros). With g_t the gradient of
// h_t from every later step:
//   g_{S-1} = dh_{S-1} + dh_last,   g_t = dh_t + a_{t+1} g_{t+1},
//   da_t = g_t h_{t-1} (h_{-1} = h0),   db_t = g_t,   dh0 = a_0 g_0.
// dh0 may be null (not computed).
//
// What bounds it on an H100: bytes. Three arrays read (a, h, dh) and two
// written (da, db), 20 bytes an element against three flops: at (16, 256,
// 2560) that is 210 MB, 0.063 ms at 3.35 TB/s.
//
// The design, a simple one that is right: one thread a chain (a batch row's
// channel), walking its steps from the last to the first, UNROLL steps of
// loads in registers at a time (no flipped copy: h is read in reverse where
// the forward wrote it). A channel's steps are adjacent to the next
// channel's in memory, so a warp's loads of a step are one 128-byte line.
// Every value is computed in one fixed order with no atomics, so two
// launches give the same bits; the carry's product is kept apart from the
// next step's add (__fmul_rn, no fused multiply-add), so the kernel gives
// the bits of its plain version, ref.decay_scan_bwd_ref.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
decay_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ h0, const float* __restrict__ dh,
                      const float* __restrict__ dh_last, float* __restrict__ da,
                      float* __restrict__ db, float* __restrict__ dh0, int64_t S,
                      int64_t C, int64_t BC) {
    const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= BC) return;
    const int64_t bi = idx / C, c = idx % C;
    const size_t base = (size_t)bi * S * C + c;
    const float start = h0 ? h0[idx] : 0.f;
    // carry: the gradient h_t receives from step t + 1 (dh_last for t = S-1)
    float carry = dh_last ? dh_last[idx] : 0.f;
    int64_t t = S;
    for (; t >= UNROLL; t -= UNROLL) {
        float av[UNROLL], hv[UNROLL], gv[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            const int64_t s = t - 1 - j;
            av[j] = __ldg(a + base + (size_t)s * C);
            gv[j] = __ldg(dh + base + (size_t)s * C);
            hv[j] = s > 0 ? __ldg(h + base + (size_t)(s - 1) * C) : start;
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            const size_t at = base + (size_t)(t - 1 - j) * C;
            const float g = gv[j] + carry;
            db[at] = g;
            da[at] = g * hv[j];
            carry = __fmul_rn(av[j], g);
        }
    }
    for (; t > 0; --t) {
        const int64_t s = t - 1;
        const size_t at = base + (size_t)s * C;
        const float g = __ldg(dh + at) + carry;
        const float hp = s > 0 ? __ldg(h + at - C) : start;
        db[at] = g;
        da[at] = g * hp;
        carry = __fmul_rn(__ldg(a + at), g);
    }
    if (dh0) dh0[idx] = carry;
}

}  // namespace

// See the top of the file for the arguments; h0, dh_last and dh0 may be null.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int pnp_decay_scan_bwd(const void* a, const void* h, const void* h0,
                                  const void* dh, const void* dh_last, void* da,
                                  void* db, void* dh0, int64_t B, int64_t S,
                                  int64_t C, void* stream) {
    if (B < 0 || S < 0 || C < 0) return (int)cudaErrorInvalidValue;
    const int64_t BC = B * C;
    if (BC == 0) return 0;
    const int64_t blocks = (BC + THREADS - 1) / THREADS;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    decay_scan_bwd_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)h, (const float*)h0, (const float*)dh,
        (const float*)dh_last, (float*)da, (float*)db, (float*)dh0, S, C, BC);
    return (int)cudaGetLastError();
}
