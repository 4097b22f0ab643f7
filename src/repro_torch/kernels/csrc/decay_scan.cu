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
// 0.30 ms at 3.35 TB/s. Each channel's steps are sequential, so only
// B x C = 20,480 chains exist; reaching the memory rate needs ~32 KB of
// loads in flight on every SM all the time (chip_probes.py's
// memory_in_flight: 4 KB an SM streams 1.3 TB/s, 32 KB ~2.8), which one
// load stream a chain cannot give.
//
// What the design does about it (`decay_scan_kernel`):
// - the work is cut into tiles of CT = 64 channels of one batch row by
//   STEPS = 128 steps (one chunk), the fastest tile in chip_probes.py's
//   decay_scan_tiles sweep, which builds this file at other -D DECAY_STEPS
//   and DECAY_WARPS: (8, 4096, 2560) is 10,240 tiles of 96 KB of traffic
//   each, so the work spreads evenly over the SMs whatever their count
//   (the one-thread-a-chain grid put 3 blocks on 56 SMs and 2 on 76);
// - a block takes its tile from a ticket (an atomic counter), chunk by
//   chunk: tile t waits only on tile t - (chains), which an earlier block
//   took and holds, so no block ever waits on one that was never
//   scheduled. The last block to finish sets the ticket back to 0, so the
//   next launch needs no reset;
// - a block first copies its tile's a and b into shared memory with
//   cp.async (16-byte pieces where rows allow, in four groups of steps),
//   and only then waits for the carry of its chains: every resident
//   block's loads are in flight while the carries travel, and only the
//   carry is serial;
// - each thread runs its channel's FMAs in step order from the h of the
//   chunk before (handed over through global memory as one 64-bit word of
//   value and chunk tag, so no fence is needed), which is the same
//   sequence of fmaf as one thread running the whole chain: the result is
//   bit for bit that of `decay_scan_per_chain_kernel` and repeats from run
//   to run;
// - h is written with streaming stores (st.global.cs): it is not read
//   again by this kernel.
// `decay_scan_per_chain_kernel` (one thread a chain over all S steps, 16
// steps of loads in registers at a time) is kept to hold the tiled kernel
// against; no path launches it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// the tiled kernel (the path's)
// ---------------------------------------------------------------------------

#ifndef DECAY_STEPS
#define DECAY_STEPS 128
#endif
#ifndef DECAY_WARPS
#define DECAY_WARPS 2
#endif
constexpr int STEPS = DECAY_STEPS;     // a chunk: the steps of a tile
constexpr int CT = 32 * DECAY_WARPS;   // the channels of a tile, a block
constexpr int GROUPS = 4;   // cp.async groups a tile's steps come in
static_assert(2 * STEPS * CT * 4 <= 227 * 1024, "tile fits shared memory");
// A carry that has not come after this long was lost (a fault in the
// kernel, not a slow predecessor, which needs microseconds): the block
// traps, which stops the launch with an error, rather than hang the card.
constexpr unsigned long long CARRY_TIMEOUT_NS = 2000000000ull;   // 2 s

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
                 : "memory");
}

// h over steps [r0, r1) of the staged tile, each stored as it is made.
__device__ __forceinline__ float scan_rows(const float* sa, const float* sb,
                                           int r0, int r1, float h,
                                           float* out, int64_t C) {
    int r = r0;
    for (; r + 8 <= r1; r += 8) {
        float av[8], bv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            av[j] = sa[(r + j) * CT];
            bv[j] = sb[(r + j) * CT];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            h = fmaf(av[j], h, bv[j]);
            __stcs(out + (int64_t)(r + j) * C, h);
        }
    }
    for (; r < r1; ++r) {
        h = fmaf(sa[r * CT], h, sb[r * CT]);
        __stcs(out + (int64_t)r * C, h);
    }
    return h;
}

// counters[0]: the ticket; counters[1]: blocks finished. carry: B x C
// words, (chunk tag << 32 | h bits); a tag of 0 means empty, and every word
// is 0 again when a launch ends.
__global__ void __launch_bounds__(CT)
decay_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  float* __restrict__ h_last, int64_t S, int64_t C,
                  int n_chunks, int n_ctiles, int n_chains, int vec,
                  unsigned long long* __restrict__ carry,
                  unsigned int* __restrict__ counters) {
    extern __shared__ float4 smem4[];
    __shared__ unsigned int tile_s;
    float* sa = reinterpret_cast<float*>(smem4);
    float* sb = sa + STEPS * CT;
    if (threadIdx.x == 0) tile_s = atomicAdd(&counters[0], 1u);
    __syncthreads();
    const unsigned int tile = tile_s;
    if (tile >= (unsigned)n_chunks * (unsigned)n_chains) __trap();
    const int chunk = (int)(tile / (unsigned)n_chains);
    const int chain = (int)(tile - (unsigned)chunk * (unsigned)n_chains);
    const int bi = chain / n_ctiles;
    const int64_t c0 = (int64_t)(chain - bi * n_ctiles) * CT;
    const int64_t t0 = (int64_t)chunk * STEPS;
    const int len = (int)(S - t0 < STEPS ? S - t0 : STEPS);
    const int cw = (int)(C - c0 < CT ? C - c0 : CT);
    const int64_t corner = ((int64_t)bi * S + t0) * C + c0;   // (bi, t0, c0)

    // 1. the tile's a and b into shared memory, GROUPS groups of steps.
    // 16-byte pieces: thread i copies piece i % (CT / 4) of rows i / (CT /
    // 4), + 4, + 8, ...; 4-byte pieces: thread i copies column i.
    const int grows = (len + GROUPS - 1) / GROUPS;
    const int q = vec ? 4 * (threadIdx.x % (CT >> 2)) : threadIdx.x;
    const int r_first = vec ? threadIdx.x / (CT >> 2) : 0;
    const int r_step = vec ? 4 : 1;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
        const int r0 = g * grows;
        const int r1 = r0 + grows < len ? r0 + grows : len;
        if (q < cw) {
            for (int r = r0 + r_first; r < r1; r += r_step) {
                const int64_t at = corner + (int64_t)r * C + q;
                if (vec) {
                    cp_async16(sa + r * CT + q, a + at);
                    cp_async16(sb + r * CT + q, b + at);
                } else {
                    cp_async4(sa + r * CT + q, a + at);
                    cp_async4(sb + r * CT + q, b + at);
                }
            }
        }
        cp_async_commit();
    }

    // 2. the carry: h0 for the first chunk, else the chunk before's h
    const bool live = threadIdx.x < cw;
    const int64_t lane_chain = (int64_t)bi * C + c0 + threadIdx.x;
    float h = 0.f;
    if (live) {
        if (chunk == 0) {
            if (h0) h = h0[lane_chain];
        } else {
            unsigned long long v, since = 0;
            unsigned int spins = 0;
            while (((v = load_relaxed(carry + lane_chain)) >> 32)
                   != (unsigned long long)chunk) {
                if ((++spins & 1023u) == 0) {   // read the clock now and then
                    const unsigned long long now = global_ns();
                    if (!since) since = now;
                    else if (now - since > CARRY_TIMEOUT_NS) __trap();
                }
            }
            h = __uint_as_float((unsigned int)v);
        }
    }

    // 3. the steps, group by group as their copies land
    float* o = out + corner + threadIdx.x;
    const float* ta = sa + threadIdx.x;
    const float* tb = sb + threadIdx.x;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
        if (g == 0) cp_async_wait<GROUPS - 1>();
        else if (g == 1) cp_async_wait<GROUPS - 2>();
        else if (g == 2) cp_async_wait<GROUPS - 3>();
        else cp_async_wait<0>();
        __syncthreads();
        const int r0 = g * grows;
        const int r1 = r0 + grows < len ? r0 + grows : len;
        if (live && r1 > r0) h = scan_rows(ta, tb, r0, r1, h, o, C);
    }

    // 4. hand h on, or finish the chain
    if (live) {
        if (chunk + 1 < n_chunks) {
            store_relaxed(carry + lane_chain,
                          ((unsigned long long)(chunk + 1) << 32)
                              | __float_as_uint(h));
        } else {
            h_last[lane_chain] = h;
            if (chunk > 0) store_relaxed(carry + lane_chain, 0ull);
        }
    }
    __syncthreads();
    if (threadIdx.x == 0
        && atomicAdd(&counters[1], 1u)
               == (unsigned)n_chunks * (unsigned)n_chains - 1u) {
        counters[0] = 0;
        counters[1] = 0;
    }
}

// ---------------------------------------------------------------------------
// one thread a chain (kept for comparison)
// ---------------------------------------------------------------------------

constexpr int CHAIN_THREADS = 64;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(CHAIN_THREADS)
decay_scan_per_chain_kernel(const float* __restrict__ a,
                            const float* __restrict__ b,
                            const float* __restrict__ h0,
                            float* __restrict__ out,
                            float* __restrict__ h_last, int64_t S, int64_t C,
                            int64_t BC) {
    const int64_t idx = (int64_t)blockIdx.x * CHAIN_THREADS + threadIdx.x;
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

// Words of workspace `pnp_decay_scan` needs at (B, C): the two counters'
// word and one carry word a chain. It must be zero before the first launch
// that uses it; every launch leaves it zero. Launches that share one
// workspace must be ordered (one stream).
extern "C" int64_t pnp_decay_scan_workspace_words(int64_t B, int64_t C) {
    return 1 + B * C;
}

// The tiled kernel, with `workspace` of pnp_decay_scan_workspace_words(B,
// C) zeroed words. a, b, out: (B, S, C); h0 (or null), h_last: (B, C);
// float32, contiguous. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int pnp_decay_scan(const void* a, const void* b,
                              const void* h0, void* out, void* h_last,
                              int64_t B, int64_t S, int64_t C,
                              void* workspace, void* stream) {
    if (B < 0 || S < 0 || C < 0 || workspace == nullptr)
        return (int)cudaErrorInvalidValue;
    if (B * C == 0) return 0;
    const int64_t n_ctiles = (C + CT - 1) / CT;
    const int64_t n_chains = B * n_ctiles;
    const int64_t n_chunks = S > 0 ? (S + STEPS - 1) / STEPS : 1;
    if (n_chains * n_chunks > (int64_t)UINT32_MAX / 2 || n_chunks >= INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * (size_t)STEPS * CT * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        decay_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int vec = (C % 4 == 0) && ((uintptr_t)a % 16 == 0)
                    && ((uintptr_t)b % 16 == 0);
    unsigned long long* words = (unsigned long long*)workspace;
    decay_scan_kernel<<<(unsigned int)(n_chains * n_chunks), CT, smem,
                        (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const float*)h0, (float*)out,
        (float*)h_last, S, C, (int)n_chunks, (int)n_ctiles,
        (int)n_chains, vec, words + 1, (unsigned int*)words);
    return (int)cudaGetLastError();
}

// One thread a chain: the same arguments, no workspace.
extern "C" int pnp_decay_scan_per_chain(const void* a, const void* b,
                                        const void* h0, void* out,
                                        void* h_last, int64_t B, int64_t S,
                                        int64_t C, void* stream) {
    if (B < 0 || S < 0 || C < 0) return (int)cudaErrorInvalidValue;
    const int64_t BC = B * C;
    if (BC == 0) return 0;
    const int64_t blocks = (BC + CHAIN_THREADS - 1) / CHAIN_THREADS;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    decay_scan_per_chain_kernel<<<(unsigned int)blocks, CHAIN_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const float*)h0, (float*)out,
        (float*)h_last, S, C, BC);
    return (int)cudaGetLastError();
}
