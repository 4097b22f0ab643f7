// Attention backward for bfloat16 on Hopper's tensor cores: dQ, dK and dV
// of the attention flash_attention_tc.cu computes, from q, k, v, its output
// o, the output's gradient dO and the row log-sum-exp its training instance
// saves.
//
// Replaces no TPU kernel: the reference has no Pallas backward; jax.grad
// differentiates repro.models.attention.chunked_attention (the function of
// the Pallas forward, src/repro/kernels/flash_attention.py:28). The port's
// bf16 training step (models/attention.py self_attention, through
// kernels/flash_attention.py's autograd Function) runs it once a layer and
// microstep: qwen3-0.6b's 28 layers at hd 128.
//
// q, o, dO, dQ (B, S, H, hd); k, v, dK, dV (B, T, Kv, hd); all bfloat16,
// contiguous, 16-byte aligned; lse (B, H, S) float32. Scores are scaled by
// 1/sqrt(hd); with `causal` query s sees keys t <= s (queries at offset 0);
// with `window` > 0 only keys t > s - window. Query head h reads KV head
// h / (H / Kv). Per (query s, key t) pair the mask keeps:
//   P = exp(q.k / sqrt(hd) - lse_s), D_s = dO_s . o_s (float32),
//   dV_t += P dO_s,  dP = dO_s . v_t,  dS = P (dP - D_s),
//   dQ_s += dS k_t / sqrt(hd),  dK_t += dS q_s / sqrt(hd).
// P and dS are rounded to bf16 for the products that take them; every sum
// is float32.
//
// What bounds it on an H100: at the training step's call (B 32, S = T 256,
// 16 heads over 8, hd 128, causal) the five products of the causal half are
// ~2.2e10 flops, 0.022 ms at the 989 TFLOP/s of the bf16 tensor cores,
// against ~201 MB of q, k, v, o, dO read and dq, dk, dv written, 0.060 ms
// at 3.35 TB/s: the bytes. At qwen3-0.6b's prefill shape (B 8, S = T 2048)
// the products bound it.
//
// The design, two launches:
// - tc_dot_kernel: D = rowsum(dO o) in float32 of every row (16 lanes a
//   row, a fixed shuffle tree), and the row's log-sum-exp times log2(e),
//   into two (B, H, S_pad) workspaces, S rounded up to an item's rows, so
//   that the main kernel copies 64 or 128 rows of each with one aligned
//   bulk copy;
// - tc_bwd_kernel: one persistent launch (MIN_BLOCKS blocks an SM) over
//   two kinds of item, each owned by one block: dK and dV of ITEM_ROWS keys
//   of one (batch row, KV head), and dQ of ITEM_ROWS query rows of one
//   (batch row, head). The wrapper (kernels/flash_attention_tc_bwd.py)
//   lists the items heaviest first; a block takes its items from that list
//   in rounds of gridDim.x, every other round reversed (a snake), so the
//   blocks' shares even out. dQ recomputes S and dP instead of reading dS
//   back from device memory: seven products of 64 x 64 x hd a visible
//   tile pair instead of five, and no S x S workspace, so the items are
//   independent and share one launch.
// A block is NC consumer warpgroups, each owning 64 of the item's rows,
// and one producer warpgroup, of which one thread issues every copy:
// - the item's resident tiles (K and V of its keys, or Q and dO of its
//   query rows, with their log-sum-exp and D) arrive by TMA through 4-D
//   tensor maps (hd, heads, rows, batch) with boxes of (64 columns, 1 head,
//   64 rows, 1) and the 128-byte swizzle, so GQA and MQA read the shared
//   KV head in place. They are only ever the A operand of the S and dP
//   products, so the next item's start to arrive as soon as both
//   warpgroups' last S and dP products of this one are done, while the
//   last stage's accumulating products and the stores still run (one
//   buffer, RES_BUFS; a second would cost the ring a stage at hd 128);
// - the streamed tiles (Q and dO with their log-sum-exp and D for each
//   visible (query tile, head of the group) pair of a dK/dV item; K and V
//   for each visible key tile of a dQ item; 64 rows each) run through a
//   ring of STAGES stages on mbarriers. Rows past S or T arrive as zeros
//   and are masked all the same;
// - per stage a consumer warpgroup runs two products with both operands in
//   shared memory as `wgmma` m64n64k16 (bf16, float32 accumulators):
//   S^T = K Q^T and dP^T = V dO^T (dK/dV), or S = Q K^T and dP = dO V^T
//   (dQ); forms P and dS in registers (the mask only on tiles across an
//   edge of the band or past S or T); rounds them to bf16 pairs, which are
//   wgmma's register A operand as they lie; and accumulates dV += P^T dO
//   and dK += dS^T Q, or dQ += dS K, with the streamed tile as the
//   transposed (MN-major) B operand. The two consumer warpgroups share the
//   tensor cores, so one's products can run while the other forms P and
//   dS.
//   `setmaxnreg` gives the consumers CONSUMER_REGS registers a thread, so
//   the 2 x 64 float32 accumulators of dK and dV at hd 128 stay in
//   registers with no spills;
// - deterministic, with no atomics: one warpgroup owns each row of dK, dV
//   and dQ and sums it in a fixed order (dK and dV over query tiles, the
//   group's heads inside; dQ over key tiles, ascending), so two launches
//   give equal bits and a miner and its verifier agree. One rule,
//   `visible`, picks the 64 x 64 tiles both kinds of item compute.
// The tile (NC, STAGES, RES_BUFS, PRODUCER_REGS) is a constant here,
// chosen by chip_probes.py's flash_tc_bwd_tiles sweep, which builds the
// other tiles with -D flags: 128 keys or query rows an item, 3 stages, 1
// resident buffer, 24 producer registers (240 for each consumer thread).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_tc_common.cuh"

#ifndef BWD_TC_CONSUMERS
#define BWD_TC_CONSUMERS 2
#endif
#ifndef BWD_TC_STAGES
#define BWD_TC_STAGES 3
#endif
#ifndef BWD_TC_RES_BUFS
#define BWD_TC_RES_BUFS 1
#endif
#ifndef BWD_TC_PRODUCER_REGS
#define BWD_TC_PRODUCER_REGS 24
#endif

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int NC = BWD_TC_CONSUMERS;        // consumer warpgroups a block
constexpr int STAGES = BWD_TC_STAGES;       // stages of the streamed ring
constexpr int RES_BUFS = BWD_TC_RES_BUFS;   // buffers of the resident tiles
constexpr int THREADS = 128 * (NC + 1);     // the last warpgroup produces
constexpr int CONSUMER_WARPS = 4 * NC;
constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;  // blocks an SM
constexpr int ROWS = 64;                    // a warpgroup's rows; a streamed tile's
constexpr int ITEM_ROWS = ROWS * NC;        // keys or query rows an item
// the registers a block starts with (what __launch_bounds__ leaves each
// thread, times its threads), and what `setmaxnreg` gives the consumers of
// it once the producer has its PRODUCER_REGS
constexpr int PRODUCER_REGS = BWD_TC_PRODUCER_REGS;
constexpr int BLOCK_REGS = 65536 / (THREADS * MIN_BLOCKS) / 8 * 8 * THREADS;
constexpr int CONSUMER_REGS =
    std::min(248, (BLOCK_REGS - 128 * PRODUCER_REGS) / (128 * NC) / 8 * 8);

// Shared memory at head dim HD: RES_BUFS resident buffers (tiles A and B of
// ITEM_ROWS rows), STAGES stages (tiles X and Y of 64 rows), each tile in
// 64-column chunks of 128-byte rows; then the resident buffers' and the
// stages' log-sum-exp and D (float32), then the barriers.
template <int HD> struct Smem {
    static constexpr uint32_t RES_TILE = ITEM_ROWS * HD * 2;
    static constexpr uint32_t STAGE_TILE = ROWS * HD * 2;
    static constexpr uint32_t RES = 2 * RES_TILE, STAGE = 2 * STAGE_TILE;
    static constexpr uint32_t RES_VEC = 2 * ITEM_ROWS * 4, STAGE_VEC = 2 * ROWS * 4;
    static constexpr uint32_t BYTES = RES_BUFS * (RES + RES_VEC) +
                                      STAGES * (STAGE + STAGE_VEC) +
                                      8 * 2 * (RES_BUFS + STAGES) + 1024;
};

// One item of the schedule: x = 2 tile + kind (0: dK and dV of keys
// [ITEM_ROWS tile, +ITEM_ROWS) of KV head h; 1: dQ of query rows [ITEM_ROWS
// tile, +ITEM_ROWS) of head h), y = h | b << 16.
struct Item {
    int dq_item, t0, h, b;
};

__device__ __forceinline__ Item read_item(const int2* __restrict__ sched, int w) {
    const int2 e = __ldg(sched + w);
    Item it;
    it.dq_item = e.x & 1;
    it.t0 = (e.x >> 1) * ITEM_ROWS;
    it.h = e.y & 0xffff;
    it.b = (int)((uint32_t)e.y >> 16);
    return it;
}

// Whether query rows [q0, q0 + qn) and keys [k0, k0 + kn), clipped to S and
// T, hold a pair inside the mask's band: the rule that picks the tiles of
// both kinds of item (the pairs' q - k over a rectangle take every value
// between its extremes, so the test is exact).
__device__ __forceinline__ bool visible(int q0, int qn, int k0, int kn, int S, int T,
                                        int causal, int window) {
    if (q0 >= S || k0 >= T) return false;
    const int q_last = min(q0 + qn, S) - 1, k_last = min(k0 + kn, T) - 1;
    return !(causal && k0 > q_last) && !(window > 0 && k_last <= q0 - window);
}

// Whether the 64 x 64 tile at (q0, k0) holds a pair outside the band or past
// S or T: only such tiles evaluate the mask.
__device__ __forceinline__ bool edge(int q0, int k0, int S, int T, int causal,
                                     int window) {
    const int q_hi = q0 + ROWS - 1, k_hi = k0 + ROWS - 1;
    return q_hi >= S || k_hi >= T || (causal && k_hi > q0) ||
           (window > 0 && k0 <= q_hi - window);
}

__device__ __forceinline__ bool keep(int qry, int key, int S, int T, int causal,
                                     int window) {
    return (qry < S) & (key < T) & (!causal | (key <= qry)) &
           ((window <= 0) | (key > qry - window));
}

// d (64 x 64) = a (the warpgroup's 64 resident rows) b^T (64 streamed rows),
// over hd; both K-major, chunks ITEM_ROWS and ROWS rows apart.
template <int HD>
__device__ __forceinline__ void ss_product(float (&d)[32], uint64_t a_desc,
                                           uint32_t b_tile) {
    const uint64_t b_desc = desc_sw128(b_tile, 16, 8 * ROW_BYTES);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(d, a_desc + (((kk / 4) * ITEM_ROWS * ROW_BYTES + (kk % 4) * 32) >> 4),
                 b_desc + (((kk / 4) * ROWS * ROW_BYTES + (kk % 4) * 32) >> 4), kk > 0);
}

// d (64 x hd) += a (64 x 64, bf16 pairs in registers, as an accumulator of
// m64n64 lies) b (the 64 streamed rows x hd, MN-major: 8 rows 1024 bytes
// apart, 64-column chunks ROWS rows apart).
template <int HD>
__device__ __forceinline__ void rs_product(float (&d)[HD / 2], const uint32_t (&a)[16],
                                           uint32_t b_tile) {
    const uint64_t b_desc = desc_sw128(b_tile, ROWS * ROW_BYTES, 8 * ROW_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
        wgmma_rs(d, f, b_desc + ((kk * 16 * ROW_BYTES) >> 4));
    }
}

// D = rowsum(dO o) of every row (a row's 16 lanes, a fixed shuffle tree)
// into Dws, and its log-sum-exp times log2(e) into Lws, both (B, H, S_pad).
template <int HD>
__global__ void __launch_bounds__(256)
tc_dot_kernel(const __nv_bfloat16* __restrict__ o,
              const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ Dws, float* __restrict__ Lws, int64_t n_rows, int S,
              int H, int S_pad) {
    constexpr int PER = HD / 16;     // elements a lane: 4 or 8
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int tx = threadIdx.x & 15;
    const int64_t r = tid >> 4;      // row of (B, S, H) in memory order
    const bool live = r < n_rows;
    float part = 0.f;
    if (live) {
        uint32_t ow[PER / 2], gw[PER / 2];
        const size_t at = (size_t)r * HD + PER * tx;
        if constexpr (PER == 8) {
            const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + at));
            const uint4 b = __ldg(reinterpret_cast<const uint4*>(dout + at));
            ow[0] = a.x; ow[1] = a.y; ow[2] = a.z; ow[3] = a.w;
            gw[0] = b.x; gw[1] = b.y; gw[2] = b.z; gw[3] = b.w;
        } else {
            const uint2 a = __ldg(reinterpret_cast<const uint2*>(o + at));
            const uint2 b = __ldg(reinterpret_cast<const uint2*>(dout + at));
            ow[0] = a.x; ow[1] = a.y;
            gw[0] = b.x; gw[1] = b.y;
        }
#pragma unroll
        for (int i = 0; i < PER / 2; ++i) {
            part = fmaf(__uint_as_float(gw[i] << 16), __uint_as_float(ow[i] << 16), part);
            part = fmaf(__uint_as_float(gw[i] & 0xffff0000u),
                        __uint_as_float(ow[i] & 0xffff0000u), part);
        }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
    if (!live || tx != 0) return;
    const int h = (int)(r % H);
    const int64_t bs = r / H;
    const int s = (int)(bs % S);
    const int64_t bh = bs / S * H + h;
    Dws[bh * S_pad + s] = part;
    Lws[bh * S_pad + s] = lse[bh * S + s] * LOG2E;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tc_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ Lws, const float* __restrict__ Dws,
              const int2* __restrict__ sched, int n_items,
              __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int S, int T, int H, int Kv, int S_pad,
              int causal, int window, float scale_log2, float scale) {
    using SM = Smem<HD>;
    constexpr int CHUNKS = HD / 64;
    extern __shared__ uint8_t smem[];
    const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
    const uint32_t s_res = base, s_stage = s_res + RES_BUFS * SM::RES;
    const uint32_t v_res = s_stage + STAGES * SM::STAGE;   // floats: L then D
    const uint32_t v_stage = v_res + RES_BUFS * SM::RES_VEC;
    const uint32_t res_full = v_stage + STAGES * SM::STAGE_VEC,
                   res_empty = res_full + 8 * RES_BUFS, st_full = res_empty + 8 * RES_BUFS,
                   st_empty = st_full + 8 * STAGES;
    const int G = H / Kv;
    const int n_q64 = (S + ROWS - 1) / ROWS, n_k64 = (T + ROWS - 1) / ROWS;
    // the block's j-th item: rounds of gridDim.x items, every other round
    // in reverse (a snake)
    auto next_item = [&](int j) {
        return (int)(j * gridDim.x + (j & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x));
    };

    if (threadIdx.x == 0) {
#pragma unroll
        for (int r = 0; r < RES_BUFS; ++r) {
            mbar_init(res_full + 8 * r, 1);
            mbar_init(res_empty + 8 * r, CONSUMER_WARPS);
        }
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(st_full + 8 * s, 1);
            mbar_init(st_empty + 8 * s, CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the warpgroup index, read from lane 0 so that the compiler sees it is
    // the same across each warp: `setmaxnreg` then holds for each branch
    const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
    if (wg == NC) {
        // ---- producer: one thread issues every copy of the block ----------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (threadIdx.x == 128 * NC) {
            // g counts the block's streamed stages over all its items: the
            // ring's stage and phase run on across items
            int g = 0, j = 0;
            auto stage_in = [&]() {
                const int stage = g % STAGES;
                if (g >= STAGES) mbar_wait(st_empty + 8 * stage, (g / STAGES - 1) & 1);
                ++g;
                return stage;
            };
            for (int w = blockIdx.x; w < n_items; w = next_item(++j)) {
                const Item it = read_item(sched, w);
                const int r = j % RES_BUFS;
                if (j >= RES_BUFS) mbar_wait(res_empty + 8 * r, (j / RES_BUFS - 1) & 1);
                const uint32_t ra = s_res + r * SM::RES, rb = ra + SM::RES_TILE;
                const uint32_t full = res_full + 8 * r;
                if (!it.dq_item) {
                    // K and V of the item's keys stay; Q, dO, L and D of each
                    // visible (query tile, head) pair stream
                    mbar_expect_tx(full, SM::RES);
#pragma unroll
                    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
                        for (int half = 0; half < NC; ++half) {
                            const uint32_t at = c * ITEM_ROWS * ROW_BYTES + half * ROWS * ROW_BYTES;
                            tma_load(ra + at, &tm_k, full, 64 * c, it.h, it.t0 + ROWS * half, it.b);
                            tma_load(rb + at, &tm_v, full, 64 * c, it.h, it.t0 + ROWS * half, it.b);
                        }
                    for (int qt = 0; qt < n_q64; ++qt) {
                        if (!visible(qt * ROWS, ROWS, it.t0, ITEM_ROWS, S, T, causal, window))
                            continue;
                        for (int hg = 0; hg < G; ++hg) {
                            const int h = it.h * G + hg, stage = stage_in();
                            const uint32_t x = s_stage + stage * SM::STAGE, y = x + SM::STAGE_TILE;
                            const uint32_t sf = st_full + 8 * stage;
                            mbar_expect_tx(sf, SM::STAGE + SM::STAGE_VEC);
#pragma unroll
                            for (int c = 0; c < CHUNKS; ++c) {
                                tma_load(x + c * ROWS * ROW_BYTES, &tm_q, sf, 64 * c, h, qt * ROWS, it.b);
                                tma_load(y + c * ROWS * ROW_BYTES, &tm_do, sf, 64 * c, h, qt * ROWS, it.b);
                            }
                            const size_t at = ((size_t)it.b * H + h) * S_pad + qt * ROWS;
                            const uint32_t vec = v_stage + stage * SM::STAGE_VEC;
                            bulk_load(vec, Lws + at, ROWS * 4, sf);
                            bulk_load(vec + ROWS * 4, Dws + at, ROWS * 4, sf);
                        }
                    }
                } else {
                    // Q, dO, L and D of the item's rows stay; K and V of each
                    // visible key tile stream
                    mbar_expect_tx(full, SM::RES + SM::RES_VEC);
#pragma unroll
                    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
                        for (int half = 0; half < NC; ++half) {
                            const uint32_t at = c * ITEM_ROWS * ROW_BYTES + half * ROWS * ROW_BYTES;
                            tma_load(ra + at, &tm_q, full, 64 * c, it.h, it.t0 + ROWS * half, it.b);
                            tma_load(rb + at, &tm_do, full, 64 * c, it.h, it.t0 + ROWS * half, it.b);
                        }
                    const size_t at = ((size_t)it.b * H + it.h) * S_pad + it.t0;
                    const uint32_t vec = v_res + r * SM::RES_VEC;
                    bulk_load(vec, Lws + at, ITEM_ROWS * 4, full);
                    bulk_load(vec + ITEM_ROWS * 4, Dws + at, ITEM_ROWS * 4, full);
                    const int kvh = it.h / G;
                    for (int kt = 0; kt < n_k64; ++kt) {
                        if (!visible(it.t0, ITEM_ROWS, kt * ROWS, ROWS, S, T, causal, window))
                            continue;
                        const int stage = stage_in();
                        const uint32_t x = s_stage + stage * SM::STAGE, y = x + SM::STAGE_TILE;
                        const uint32_t sf = st_full + 8 * stage;
                        mbar_expect_tx(sf, SM::STAGE);
#pragma unroll
                        for (int c = 0; c < CHUNKS; ++c) {
                            tma_load(x + c * ROWS * ROW_BYTES, &tm_k, sf, 64 * c, kvh, kt * ROWS, it.b);
                            tma_load(y + c * ROWS * ROW_BYTES, &tm_v, sf, 64 * c, kvh, kt * ROWS, it.b);
                        }
                    }
                }
            }
        }
    } else {
        // ---- consumers: 64 of the item's rows each ----------------------
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
        const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
        // the accumulator layout of wgmma (m64nN, f32): element 4 j + 2 i + e
        // of a thread is row `ra` + 8 i, column 8 j + `col` + e
        const int ra = 16 * warp + lane / 4, col = 2 * (lane % 4);
        const float* vecs = reinterpret_cast<const float*>(smem + (v_res - smem_u32(smem)));
        auto release = [&](uint32_t bar) {
            __syncwarp();
            if (lane == 0) mbar_arrive(bar);
        };
        int g = 0, j = 0;
        for (int w = blockIdx.x; w < n_items; w = next_item(++j)) {
            const Item it = read_item(sched, w);
            const int r = j % RES_BUFS;
            // the warpgroup's 64 rows of the resident tiles, K-major
            const uint32_t ra_tile = s_res + r * SM::RES + wg * ROWS * ROW_BYTES;
            const uint64_t a_desc = desc_sw128(ra_tile, 16, 8 * ROW_BYTES);
            const uint64_t b_desc = desc_sw128(ra_tile + SM::RES_TILE, 16, 8 * ROW_BYTES);
            const int own0 = it.t0 + ROWS * wg;   // the warpgroup's first key or query row
            mbar_wait(res_full + 8 * r, (j / RES_BUFS) & 1);
            if (!it.dq_item) {
                float acc_v[HD / 2], acc_k[HD / 2];
#pragma unroll
                for (int i = 0; i < HD / 2; ++i) acc_v[i] = acc_k[i] = 0.f;
                // K and V are read by the S^T and dP^T products alone: the
                // warpgroup frees them once its last pair's are done
                int last = n_q64 - 1;
                while (last >= 0 && !visible(last * ROWS, ROWS, own0, ROWS, S, T, causal, window))
                    --last;
                if (last < 0) release(res_empty + 8 * r);
                for (int qt = 0; qt < n_q64; ++qt) {
                    const int q0 = qt * ROWS;
                    if (!visible(q0, ROWS, it.t0, ITEM_ROWS, S, T, causal, window)) continue;
                    const bool mine = visible(q0, ROWS, own0, ROWS, S, T, causal, window);
                    const bool masked = edge(q0, own0, S, T, causal, window);
                    for (int hg = 0; hg < G; ++hg, ++g) {
                        const int stage = g % STAGES;
                        mbar_wait(st_full + 8 * stage, (g / STAGES) & 1);
                        if (!mine) {
                            release(st_empty + 8 * stage);
                            continue;
                        }
                        const uint32_t x = s_stage + stage * SM::STAGE, y = x + SM::STAGE_TILE;
                        const float* lv = vecs + (RES_BUFS * SM::RES_VEC + stage * SM::STAGE_VEC) / 4;
                        const float* dd = lv + ROWS;
                        // S^T = K Q^T and dP^T = V dO^T: rows are the
                        // warpgroup's keys, columns the tile's queries
                        float s[32], dp[32];
                        wgmma_fence();
                        ss_product<HD>(s, a_desc, x);
                        ss_product<HD>(dp, b_desc, y);
                        wgmma_commit();
                        wgmma_wait<0>();
                        fence_regs(s);
                        fence_regs(dp);
                        if (qt == last && hg == G - 1) release(res_empty + 8 * r);
                        // P^T
#pragma unroll
                        for (int jj = 0; jj < 8; ++jj) {
                            const float2 l2 = *reinterpret_cast<const float2*>(lv + 8 * jj + col);
#pragma unroll
                            for (int i = 0; i < 2; ++i)
#pragma unroll
                                for (int e = 0; e < 2; ++e) {
                                    const int at = 4 * jj + 2 * i + e;
                                    const float p = ex2(fmaf(s[at], scale_log2, -(e ? l2.y : l2.x)));
                                    s[at] = masked & !keep(q0 + 8 * jj + col + e, own0 + ra + 8 * i,
                                                           S, T, causal, window) ? 0.f : p;
                                }
                        }
                        uint32_t pa[16], da[16];
#pragma unroll
                        for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
                        // dS^T = P^T (dP^T - D)
#pragma unroll
                        for (int jj = 0; jj < 8; ++jj) {
                            const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * jj + col);
#pragma unroll
                            for (int i = 0; i < 2; ++i)
#pragma unroll
                                for (int e = 0; e < 2; ++e) {
                                    const int at = 4 * jj + 2 * i + e;
                                    // a masked P is 0, and so is its dS (D
                                    // past S is not a number)
                                    dp[at] = s[at] == 0.f ? 0.f : s[at] * (dp[at] - (e ? d2.y : d2.x));
                                }
                        }
#pragma unroll
                        for (int i = 0; i < 16; ++i) da[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
                        // dV += P^T dO and dK += dS^T Q
                        wgmma_fence();
                        rs_product<HD>(acc_v, pa, y);
                        rs_product<HD>(acc_k, da, x);
                        wgmma_commit();
                        wgmma_wait<0>();
                        fence_regs(pa);
                        fence_regs(da);
                        fence_regs(acc_v);
                        fence_regs(acc_k);
                        release(st_empty + 8 * stage);
                    }
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int key = own0 + ra + 8 * i;
                    if (key >= T) continue;
                    const size_t at = (((size_t)it.b * T + key) * Kv + it.h) * HD + col;
#pragma unroll
                    for (int c = 0; c < HD / 8; ++c) {
                        *reinterpret_cast<uint32_t*>(dk + at + 8 * c) = pack_bf16(
                            acc_k[4 * c + 2 * i] * scale, acc_k[4 * c + 2 * i + 1] * scale);
                        *reinterpret_cast<uint32_t*>(dv + at + 8 * c) =
                            pack_bf16(acc_v[4 * c + 2 * i], acc_v[4 * c + 2 * i + 1]);
                    }
                }
            } else {
                float acc_q[HD / 2];
#pragma unroll
                for (int i = 0; i < HD / 2; ++i) acc_q[i] = 0.f;
                const float* lv = vecs + (r * SM::RES_VEC) / 4 + ROWS * wg;
                const float lrow[2] = {lv[ra], lv[ra + 8]};
                const float drow[2] = {lv[ITEM_ROWS + ra], lv[ITEM_ROWS + ra + 8]};
                // Q and dO are read by the S and dP products alone
                int last = n_k64 - 1;
                while (last >= 0 && !visible(own0, ROWS, last * ROWS, ROWS, S, T, causal, window))
                    --last;
                if (last < 0) release(res_empty + 8 * r);
                for (int kt = 0; kt < n_k64; ++kt) {
                    const int k0 = kt * ROWS;
                    if (!visible(it.t0, ITEM_ROWS, k0, ROWS, S, T, causal, window)) continue;
                    const int stage = g % STAGES;
                    mbar_wait(st_full + 8 * stage, (g / STAGES) & 1);
                    ++g;
                    if (!visible(own0, ROWS, k0, ROWS, S, T, causal, window)) {
                        release(st_empty + 8 * stage);
                        continue;
                    }
                    const uint32_t x = s_stage + stage * SM::STAGE, y = x + SM::STAGE_TILE;
                    const bool masked = edge(own0, k0, S, T, causal, window);
                    // S = Q K^T and dP = dO V^T: rows are the warpgroup's
                    // queries, columns the tile's keys
                    float s[32], dp[32];
                    wgmma_fence();
                    ss_product<HD>(s, a_desc, x);
                    ss_product<HD>(dp, b_desc, y);
                    wgmma_commit();
                    wgmma_wait<0>();
                    fence_regs(s);
                    fence_regs(dp);
                    if (kt == last) release(res_empty + 8 * r);
                    // P
#pragma unroll
                    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                        for (int i = 0; i < 2; ++i)
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const int at = 4 * jj + 2 * i + e;
                                const float p = ex2(fmaf(s[at], scale_log2, -lrow[i]));
                                s[at] = masked & !keep(own0 + ra + 8 * i, k0 + 8 * jj + col + e,
                                                       S, T, causal, window) ? 0.f : p;
                            }
                    // dS = P (dP - D); then dQ += dS K
                    uint32_t da[16];
#pragma unroll
                    for (int i = 0; i < 16; ++i) {
                        const int i0 = 2 * i, i1 = 2 * i + 1;   // row ra + 8 (i % 2)
                        da[i] = pack_bf16(
                            s[i0] == 0.f ? 0.f : s[i0] * (dp[i0] - drow[i % 2]),
                            s[i1] == 0.f ? 0.f : s[i1] * (dp[i1] - drow[i % 2]));
                    }
                    wgmma_fence();
                    rs_product<HD>(acc_q, da, x);
                    wgmma_commit();
                    wgmma_wait<0>();
                    fence_regs(da);
                    fence_regs(acc_q);
                    release(st_empty + 8 * stage);
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int row = own0 + ra + 8 * i;
                    if (row >= S) continue;
                    const size_t at = (((size_t)it.b * S + row) * H + it.h) * HD + col;
#pragma unroll
                    for (int c = 0; c < HD / 8; ++c)
                        *reinterpret_cast<uint32_t*>(dq + at + 8 * c) = pack_bf16(
                            acc_q[4 * c + 2 * i] * scale, acc_q[4 * c + 2 * i + 1] * scale);
                }
            }
        }
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* Dws, float* Lws, const int2* sched, int n_items, int64_t B,
           int64_t S, int64_t T, int H, int Kv, int causal, int window,
           cudaStream_t stream) {
    using bf = __nv_bfloat16;
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, tc_bwd_kernel<HD>);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg only moves registers between the block's warpgroups: the
    // block must start with all that the consumers and the producer take
    if (attr.numRegs * THREADS < 128 * (NC * CONSUMER_REGS + PRODUCER_REGS))
        return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(tc_bwd_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<HD>::BYTES);
    if (err != cudaSuccess) return (int)err;
    alignas(64) CUtensorMap mq, mk, mv, mdo;
    if (!encode(fn, &mq, q, B, S, H, HD, ROWS) || !encode(fn, &mk, k, B, T, Kv, HD, ROWS) ||
        !encode(fn, &mv, v, B, T, Kv, HD, ROWS) || !encode(fn, &mdo, dout, B, S, H, HD, ROWS))
        return (int)cudaErrorInvalidValue;
    int device, sms;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int S_pad = (int)((S + ITEM_ROWS - 1) / ITEM_ROWS * ITEM_ROWS);
    const int64_t n_rows = B * S * H;
    tc_dot_kernel<HD><<<(unsigned int)((n_rows * 16 + 255) / 256), 256, 0, stream>>>(
        (const bf*)o, (const bf*)dout, lse, Dws, Lws, n_rows, (int)S, H, S_pad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const float scale = 1.f / sqrtf((float)HD);
    tc_bwd_kernel<HD><<<(unsigned int)std::min(n_items, sms * MIN_BLOCKS), THREADS,
                        Smem<HD>::BYTES, stream>>>(
        mq, mk, mv, mdo, Lws, Dws, sched, n_items, (bf*)dq, (bf*)dk, (bf*)dv, (int)S,
        (int)T, H, Kv, S_pad, causal, window, LOG2E * scale, scale);
    return (int)cudaGetLastError();
}

template <typename F>
int resources(F kernel, int32_t* out) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    out[0] = err == cudaSuccess ? attr.numRegs : -1;
    out[1] = err == cudaSuccess ? (int32_t)attr.localSizeBytes : -1;
    return (int)err;
}

template <int HD>
int info(int32_t* out) {
    out[0] = ITEM_ROWS;
    out[1] = STAGES;
    out[2] = RES_BUFS;
    out[3] = Smem<HD>::BYTES;
    out[4] = CONSUMER_REGS;
    out[5] = PRODUCER_REGS;
    out[6] = MIN_BLOCKS;
    return resources(tc_dot_kernel<HD>, out + 7) | resources(tc_bwd_kernel<HD>, out + 9);
}

}  // namespace

// The tile at head dim `hd`, as 11 ints: rows an item (keys of a dK/dV
// item, query rows of a dQ item), stages of the streamed ring, resident
// buffers, dynamic shared bytes, `setmaxnreg`'s consumer and producer
// registers, blocks an SM; then the registers a thread and local (spilled)
// bytes the runtime reports for tc_dot_kernel and tc_bwd_kernel.
extern "C" int pnp_flash_attention_tc_bwd_info(int32_t hd, int32_t* out) {
    switch (hd) {
        case 64: return info<64>(out);
        case 128: return info<128>(out);
        default: return (int)cudaErrorInvalidValue;
    }
}

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, T, Kv, hd); bfloat16,
// contiguous, 16-byte aligned; lse: (B, H, S) float32; hd in {64, 128};
// H % Kv == 0; window 0 for none. Workspaces (tc_dot_kernel fills them): Dws
// and Lws float32 (B, H, S_pad), S rounded up to an item's rows, 16-byte
// aligned. sched: the n_items items (int2, see Item), each (kind, tile,
// head, batch row) once. Launches tc_dot_kernel and tc_bwd_kernel on
// `stream`; returns cudaGetLastError() (or the error that kept a kernel
// from launching).
extern "C" int pnp_flash_attention_tc_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse,
                                          const void* dout, void* dq, void* dk,
                                          void* dv, void* Dws, void* Lws,
                                          const void* sched, int64_t n_items, int64_t B,
                                          int64_t S, int64_t T, int32_t H, int32_t Kv,
                                          int32_t hd, int32_t causal, int32_t window,
                                          void* stream) {
    if (B < 0 || S < 0 || T < 1 || H < 1 || Kv < 1 || H % Kv || window < 0 ||
        S > INT32_MAX - ITEM_ROWS || T > INT32_MAX - ITEM_ROWS || B > 65535 ||
        H > 65535 || n_items < 0 || n_items > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
         (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)Dws | (uintptr_t)Lws |
         (uintptr_t)sched) % 16)
        return (int)cudaErrorMisalignedAddress;
    if (B == 0 || S == 0) return 0;
    if (n_items == 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define PNP_TC_BWD_ARGS q, k, v, o, (const float*)lse, dout, dq, dk, dv, (float*)Dws, \
        (float*)Lws, (const int2*)sched, (int)n_items, B, S, T, H, Kv, causal, window, st
    switch (hd) {
        case 64: return launch<64>(PNP_TC_BWD_ARGS);
        case 128: return launch<128>(PNP_TC_BWD_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef PNP_TC_BWD_ARGS
}
