// Attention forward for bfloat16 on Hopper's tensor cores (flash attention).
//
// Replaces: src/repro/kernels/flash_attention.py `_flash_kernel` /
// `flash_attention_pallas` (reached through `ops.flash_attention`), whose
// function is `repro.models.attention.chunked_attention`'s, for bfloat16
// inputs at head dims 64, 80, 128 and 256: every bf16 attention layer of
// the served models computes it (causal prefill, with recurrentgemma-2b's
// window; whisper's encoder and every cross-attention not causal, S != T,
// S = 1 at a decode step). float32 inputs and head dims 16 and 32 stay on
// the CUDA-core kernel of flash_attention.cu; the wrapper
// (kernels/flash_attention.py) chooses by dtype and head dim alone.
//
// q (B, S, H, hd), k and v (B, T, Kv, hd), out (B, S, H, hd), bfloat16,
// contiguous. Scores in float32, scaled by 1/sqrt(hd); out = acc /
// max(l, 1e-20). With `causal`, query s sees keys t <= s (queries at
// offset 0); with `window` > 0 only keys t > s - window. Query head h
// reads KV head h / (H / Kv). A row with no key in its band gives zeros.
//
// What bounds it on an H100: operations. At qwen3-0.6b's prefill (S = T
// 2048, hd 128, causal) it needs 4 hd flops per (query, key) pair against
// 2 hd bytes of q and out per query, far above the ~295 flops a byte at
// which the bf16 tensor cores (989 TFLOP/s) and HBM (3.35 TB/s) balance.
//
// What the design does about it:
// - both products run on the tensor cores as `wgmma.mma_async` in bf16
//   with float32 accumulators in registers: S = Q K^T with Q and K read
//   from shared memory, O += P V with P rounded to bf16 and fed from the
//   registers that held S, V read from shared memory as a transposed
//   (MN-major) operand. bf16 x bf16 products are exact in float32, so the
//   scores carry the reference's float32 math; the only new rounding is
//   P's, at bf16;
// - TMA copies the Q tile and the K and V tiles straight from the
//   (B, S, H, hd) layout through 4-D tensor maps (hd, H or Kv, S or T, B),
//   boxes of (64 columns, 1 head, rows, 1), so GQA and MQA read the shared
//   KV head in place and no transposed or repeated copy is made. The
//   128-byte swizzle caps a box at 64 bf16 columns, so hd 128 and 256 rows
//   arrive as 64-column chunks, and the wgmma descriptors step over them.
//   Rows past S or T arrive as zeros; keys past T are masked all the same;
// - head dim 80 (stablelm-3b) runs the hd-128 pipeline: its 160-byte rows
//   are no whole number of 128-byte swizzle boxes, so the tensor maps keep
//   an hd extent of 80 and bring two 64-column boxes, TMA filling columns
//   80-127 with zeros. S = Q K^T takes only the five k16 steps of the 80
//   columns; O += P V runs at N = 128, its columns 80-127 stay 0 and are
//   not stored. That costs 1.3x the products (8 k16 steps of P V where 5
//   would do, beside S's 5), and the shared memory and registers of hd
//   128;
// - a warp-specialised pipeline: a block of three warpgroups on each SM
//   (persistent), looping over (128 query rows, head, batch row) items,
//   the heaviest causal ones first, dealt to the blocks in snake order so
//   their shares even out. One producer thread keeps a ring of
//   K and V stages in flight on mbarriers (3 stages at hd 64 and 128, 2 at
//   256), K and V released separately, and loads the next item's Q as
//   soon as the last S product of the current one is done. The two
//   consumer warpgroups own 64 query rows each and run the online softmax
//   in registers; a warpgroup issues S of tile t beside P V of tile t - 1
//   (rescaling O between the two issues), so its softmax of tile t runs
//   while the tensor cores finish P V.
//   `setmaxnreg` gives the consumers 232 registers a thread and the
//   producer 40, so the 128-float O accumulator of hd 256 fits with no
//   spills;
// - masks only where needed: a tile entirely outside a warpgroup's causal
//   or window band is skipped (the item loads only the tiles its rows can
//   see), a tile entirely inside runs unmasked, and only the tiles across
//   the diagonal, the window's edge or the end of T evaluate the mask;
// - deterministic: one warpgroup owns each output row and its keys reduce
//   in a fixed order (no split over keys, no atomics), so two launches
//   give equal bits.
//
// The training instance (LSE = true, hd 64, 128 and 256; the forward of
// kernels/flash_attention.py's autograd Function for bfloat16) also writes
// each row's log-sum-exp of its scaled scores, float32 (B, H, S) in
// natural-log units, for the backward (flash_attention_tc_bwd.cu at hd 64
// and 128, flash_attention_mma_bwd.cu at hd 256); a row
// that sees no key writes -1e30, as ref.flash_attention_lse_ref does. Its
// output is the serving instance's (LSE = false) bit for bit: the store is
// the only difference.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_tc_common.cuh"

namespace {

constexpr int BQ = 128;              // query rows a block: two warpgroups of 64
constexpr int THREADS = 384;         // warpgroups 0 and 1 consume, 2 produces
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40;    // 2 x 128 x 232 + 128 x 40 = 384 x 168
constexpr int CONSUMER_REGS = 232;
constexpr float NEG_INF_LSE = -1e30f;  // the log-sum-exp of a row with no key
constexpr float LN2 = 0.6931471805599453f;

// Keys a tile and stages in the ring, by head dim: the S tile (64 x BK)
// and the O accumulator (64 x hd) of a consumer thread share its registers,
// and Q and the stages the 227 KB of shared memory: a third stage fits up
// to hd 128 and lets the producer run two tiles ahead; hd 256 has room
// for two.
template <int HD> struct Tile;
template <> struct Tile<64> { static constexpr int BK = 128, STAGES = 3; };
template <> struct Tile<128> { static constexpr int BK = 128, STAGES = 3; };
template <> struct Tile<256> { static constexpr int BK = 64, STAGES = 2; };

// The head dim the pipeline runs at: hd 80 pads to 128 (see the header).
template <int HD> __host__ __device__ constexpr int padded() {
    return HD == 80 ? 128 : HD;
}

template <int HD> constexpr int smem_bytes() {
    return BQ * HD * 2 + 2 * Tile<HD>::STAGES * Tile<HD>::BK * HD * 2 +
           8 * (2 + 4 * Tile<HD>::STAGES) + 1024;   // + barriers, alignment
}

// 1 / x, to within an ulp (flush to zero)
__device__ __forceinline__ float rcp(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// What one consumer warpgroup keeps of its 64 rows across key tiles. The
// accumulator layout of wgmma (m64nN, f32): element 4 j + 2 i + e of a
// thread is row `ra` + 8 i, column 8 j + `col` + e.
template <int HD>
struct RowState {
    float acc[HD / 2];
    float m[2], l[2];     // running max (raw scores), this thread's share of the sum
    int ra, col;
};

// Masks (where the tile crosses an edge of the band) and exponentiates one
// S tile in place, updating the running max and sum; returns in `alpha`
// the factors that rescale the rows' accumulators.
template <int HD, int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], RowState<HD>& st,
                                             float (&alpha)[2], bool edge, int k0,
                                             int T_len, int causal, int window,
                                             float scale_log2) {
    if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int row = st.ra + 8 * i, key = k0 + 8 * j + st.col + e;
                    const bool keep = key < T_len && (!causal || key <= row) &&
                                      (window <= 0 || key > row - window);
                    if (!keep) s[4 * j + 2 * i + e] = -INFINITY;
                }
    }
    // the four threads of a quad share a row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
            mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(st.m[i], mx);
        // a row with no key seen yet keeps p = 0 (no inf - inf)
        const float ms = m_new == -INFINITY ? 0.f : m_new * scale_log2;
        alpha[i] = ex2(st.m[i] * scale_log2 - ms);
        st.m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float p = ex2(fmaf(s[4 * j + 2 * i + e], scale_log2, -ms));
                s[4 * j + 2 * i + e] = p;
                sum += p;
            }
        st.l[i] = st.l[i] * alpha[i] + sum;
    }
}

// One work item: a block's 128 query rows of one head of one batch row,
// and the key tiles some row of it can see (causal items stop at the
// diagonal, windowed ones start at their first row's band).
struct Item {
    int q0, h, b, kt_first, n_tiles;
};

// Item w of the B * H * ceil(S / BQ) items, the heaviest (last) causal
// query tiles first, so the long items are spread over the SMs and the
// short ones fill in last.
template <int BK>
__device__ __forceinline__ Item work_item(int w, int S, int T_len, int H, int B,
                                          int causal, int window) {
    const int n_qt = (S + BQ - 1) / BQ;
    const int rest = w % (H * B);
    Item it;
    it.q0 = (n_qt - 1 - w / (H * B)) * BQ;
    it.h = rest % H;
    it.b = rest / H;
    const int q_last = min(it.q0 + BQ, S) - 1;
    int kt_end = (T_len + BK - 1) / BK;
    if (causal) kt_end = min(kt_end, q_last / BK + 1);
    it.kt_first = window > 0 ? max(0, it.q0 - window + 1) / BK : 0;
    it.n_tiles = max(0, kt_end - it.kt_first);
    return it;
}

// HD is the inputs' head dim; HP, the pipeline's (padded<HD>), sizes the
// tiles, the stages and O's accumulator.
template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B,
                int S, int T_len, int H, int Kv, int causal, int window,
                float scale_log2) {
    constexpr int HP = padded<HD>();
    constexpr int BK = Tile<HP>::BK, STAGES = Tile<HP>::STAGES;
    constexpr int CHUNKS = HP / 64;
    constexpr uint32_t Q_BYTES = BQ * HP * 2, KV_BYTES = BK * HP * 2;
    extern __shared__ uint8_t smem[];
    // [Q: CHUNKS x BQ rows][K: STAGES x CHUNKS x BK rows][V: the same]
    // [barriers: Q full, Q empty; K full, V full, K empty, V empty, STAGES
    // each]; a chunk row is 128 bytes
    const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
    const uint32_t sK = sQ + Q_BYTES, sV = sK + STAGES * KV_BYTES;
    const uint32_t q_full = sV + STAGES * KV_BYTES, q_empty = q_full + 8;
    const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * STAGES,
                   k_empty = v_full + 8 * STAGES, v_empty = k_empty + 8 * STAGES;
    const int n_work = (S + BQ - 1) / BQ * H * B;
    // the block's j-th item: rounds of gridDim.x items, every other round
    // in reverse (a snake), so the blocks' shares of work even out
    auto next_item = [&](int j) {
        return (int)(j * gridDim.x + (j & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x));
    };

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        mbar_init(q_empty, CONSUMER_WARPS);
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(k_full + 8 * s, 1);
            mbar_init(v_full + 8 * s, 1);
            mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
            mbar_init(v_empty + 8 * s, CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the warpgroup index, read from lane 0 so that the compiler sees it is
    // the same across each warp: `setmaxnreg` then holds for each branch
    const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
    if (wg == 2) {
        // ---- producer: one thread issues every copy of the block ----------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (threadIdx.x == 256) {
            // g counts the block's key tiles over all its items: the ring's
            // stage and phase run on across items
            int g = 0, j = 0;
            for (int w = blockIdx.x; w < n_work; w = next_item(++j)) {
                const Item it = work_item<BK>(w, S, T_len, H, B, causal, window);
                const int kvh = it.h / (H / Kv);
                // Q is refilled once all consumer warps have run their last
                // S product of the previous item
                if (j > 0) mbar_wait(q_empty, (j - 1) & 1);
                mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
                for (int c = 0; c < CHUNKS; ++c)
                    tma_load(sQ + c * BQ * ROW_BYTES, &tm_q, q_full, 64 * c, it.h,
                             it.q0, it.b);
                // K and V of a stage are refilled separately, each once all
                // consumer warps released it: K after its S product, V after
                // its P V product
                for (int t = 0; t < it.n_tiles; ++t, ++g) {
                    const int stage = g % STAGES, k0 = (it.kt_first + t) * BK;
                    const uint32_t parity = (g / STAGES - 1) & 1;
                    if (g >= STAGES) mbar_wait(k_empty + 8 * stage, parity);
                    mbar_expect_tx(k_full + 8 * stage, KV_BYTES);
#pragma unroll
                    for (int c = 0; c < CHUNKS; ++c)
                        tma_load(sK + stage * KV_BYTES + c * BK * ROW_BYTES, &tm_k,
                                 k_full + 8 * stage, 64 * c, kvh, k0, it.b);
                    if (g >= STAGES) mbar_wait(v_empty + 8 * stage, parity);
                    mbar_expect_tx(v_full + 8 * stage, KV_BYTES);
#pragma unroll
                    for (int c = 0; c < CHUNKS; ++c)
                        tma_load(sV + stage * KV_BYTES + c * BK * ROW_BYTES, &tm_v,
                                 v_full + 8 * stage, 64 * c, kvh, k0, it.b);
                }
            }
        }
    } else {
        // ---- consumers: 64 query rows each, online softmax in registers ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
        const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
        auto release = [&](uint32_t bar) {
            __syncwarp();
            if (lane == 0) mbar_arrive(bar);
        };
        // descriptors: S = Q K^T steps 16 columns of hd a wgmma (32 bytes;
        // a 64-column chunk holds four, chunks lie BQ or BK rows apart), both
        // K-major; O += P V steps 16 keys (16 rows), V MN-major with 8 keys
        // 1024 bytes apart and 64-column chunks BK rows apart
        const uint64_t q_desc = desc_sw128(sQ + wg * 64 * ROW_BYTES, 16, 8 * ROW_BYTES);
        RowState<HP> st;
        st.col = 2 * (lane % 4);
        auto s_product = [&](float (&s)[BK / 2], int stage) {
            const uint64_t k_desc =
                desc_sw128(sK + stage * KV_BYTES, 16, 8 * ROW_BYTES);
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)   // hd 80: 5 of HP's 8
                wgmma_ss(s, q_desc + (((kk / 4) * BQ * ROW_BYTES + (kk % 4) * 32) >> 4),
                         k_desc + (((kk / 4) * BK * ROW_BYTES + (kk % 4) * 32) >> 4),
                         kk > 0);
            wgmma_commit();
        };
        auto pv_product = [&](const uint32_t (&pk)[BK / 4], int stage) {
            const uint64_t v_desc =
                desc_sw128(sV + stage * KV_BYTES, BK * ROW_BYTES, 8 * ROW_BYTES);
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                // P's bf16 pairs are wgmma's A fragments as they lie: keys
                // 16 kk .. 16 kk + 15 are elements 8 kk .. 8 kk + 7
                const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                                       pk[4 * kk + 3]};
                wgmma_rs(st.acc, a, v_desc + ((kk * 16 * ROW_BYTES) >> 4));
            }
            wgmma_commit();
        };

        int g = 0, j = 0;
        for (int w = blockIdx.x; w < n_work; w = next_item(++j)) {
            const Item item = work_item<BK>(w, S, T_len, H, B, causal, window);
            const int row0 = item.q0 + 64 * wg;          // the warpgroup's rows
            const int row_hi = min(row0 + 63, S - 1);
            st.ra = row0 + 16 * warp + lane / 4;         // this thread's: ra, ra + 8
#pragma unroll
            for (int i = 0; i < HP / 2; ++i) st.acc[i] = 0.f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                st.m[i] = -INFINITY;
                st.l[i] = 0.f;
            }
            // The same for the whole warpgroup: a tile lies outside its band
            // (skipped), inside it, or across an edge (diagonal, window, end
            // of T). The skipped tiles are a prefix (window) and a suffix
            // (causal) of the item's tiles; the warpgroup computes [lo, hi).
            auto skip = [&](int t) {
                const int k0 = (item.kt_first + t) * BK;
                return row0 >= S || (causal && k0 > row_hi) ||
                       (window > 0 && k0 + BK - 1 <= row0 - window);
            };
            auto edge = [&](int t) {
                const int k0 = (item.kt_first + t) * BK, k_hi = k0 + BK - 1;
                return k_hi >= T_len || (causal && k_hi > row0) ||
                       (window > 0 && k0 <= row_hi - window);
            };
            int lo = 0, hi = item.n_tiles;
            while (lo < hi && skip(lo)) ++lo;
            while (hi > lo && skip(hi - 1)) --hi;
            // the ring position of the item's tile t
            auto stage_of = [&](int t) { return (g + t) % STAGES; };
            auto parity_of = [&](int t) { return (uint32_t)((g + t) / STAGES) & 1; };
            // a tile the warpgroup does not compute is released once it arrived
            auto pass = [&](int t) {
                mbar_wait(k_full + 8 * stage_of(t), parity_of(t));
                release(k_empty + 8 * stage_of(t));
                mbar_wait(v_full + 8 * stage_of(t), parity_of(t));
                release(v_empty + 8 * stage_of(t));
            };

            mbar_wait(q_full, j & 1);
            for (int t = 0; t < lo; ++t) pass(t);
            if (lo == hi) release(q_empty);   // no S product of this item
            if (lo < hi) {
                // P of the last tile, as bf16 pairs; each S tile is a fresh
                // array (the first wgmma overwrites it), so no value of it
                // lives from one tile to the next
                uint32_t pk[BK / 4];
                float alpha[2];
                // the first tile: S, softmax, P
                int stage = stage_of(lo);
                mbar_wait(k_full + 8 * stage, parity_of(lo));
                float s[BK / 2];
                wgmma_fence();
                s_product(s, stage);
                wgmma_wait<0>();
                fence_regs(s);
                release(k_empty + 8 * stage);
                if (hi == lo + 1) release(q_empty);   // Q's last use here
                softmax_tile<HP, BK>(s, st, alpha, edge(lo), (item.kt_first + lo) * BK,
                                     T_len, causal, window, scale_log2);
#pragma unroll
                for (int i = 0; i < BK / 4; ++i) pk[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
                // then, per tile: S of this tile runs on the tensor cores
                // beside P V of the last; the last tile's rescale of O runs
                // while S computes, this tile's softmax while P V does
                for (int t = lo + 1; t < hi; ++t) {
                    const int prev = stage;
                    stage = stage_of(t);
                    mbar_wait(k_full + 8 * stage, parity_of(t));
                    mbar_wait(v_full + 8 * prev, parity_of(t - 1));
                    float sn[BK / 2];
                    wgmma_fence();
                    s_product(sn, stage);
#pragma unroll
                    for (int i = 0; i < HP / 8; ++i) {
                        st.acc[4 * i] *= alpha[0];
                        st.acc[4 * i + 1] *= alpha[0];
                        st.acc[4 * i + 2] *= alpha[1];
                        st.acc[4 * i + 3] *= alpha[1];
                    }
                    fence_regs(st.acc);
                    wgmma_fence();
                    pv_product(pk, prev);
                    wgmma_wait<1>();          // S is done, P V may still run
                    fence_regs(sn);
                    release(k_empty + 8 * stage);
                    if (t == hi - 1) release(q_empty);   // Q's last use here
                    softmax_tile<HP, BK>(sn, st, alpha, edge(t), (item.kt_first + t) * BK,
                                         T_len, causal, window, scale_log2);
                    wgmma_wait<0>();
                    fence_regs(st.acc);
                    release(v_empty + 8 * prev);
#pragma unroll
                    for (int i = 0; i < BK / 4; ++i)
                        pk[i] = pack_bf16(sn[2 * i], sn[2 * i + 1]);
                }
                // the last tile's P V
                mbar_wait(v_full + 8 * stage, parity_of(hi - 1));
#pragma unroll
                for (int i = 0; i < HP / 8; ++i) {
                    st.acc[4 * i] *= alpha[0];
                    st.acc[4 * i + 1] *= alpha[0];
                    st.acc[4 * i + 2] *= alpha[1];
                    st.acc[4 * i + 3] *= alpha[1];
                }
                fence_regs(st.acc);
                wgmma_fence();
                pv_product(pk, stage);
                wgmma_wait<0>();
                fence_regs(st.acc);
                release(v_empty + 8 * stage);
            }
            for (int t = hi; t < item.n_tiles; ++t) pass(t);
            g += item.n_tiles;

            // out = acc / max(l, 1e-20), as a product with the reciprocal: an
            // IEEE division calls a subroutine, whose calling convention would
            // cost the accumulators their registers
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                float l = st.l[i];
                l += __shfl_xor_sync(0xffffffffu, l, 1);
                l += __shfl_xor_sync(0xffffffffu, l, 2);
                const int row = st.ra + 8 * i;
                if (row >= S) continue;
                if constexpr (LSE) {
                    // in the log2 domain of the raw scores the row's
                    // log-sum-exp is m scale_log2 + log2 l; the quad's four
                    // threads hold the same m and l, the first writes
                    if (lane % 4 == 0)
                        lse[((size_t)item.b * H + item.h) * S + row] =
                            st.m[i] == -INFINITY
                                ? NEG_INF_LSE
                                : (st.m[i] * scale_log2 + __log2f(l)) * LN2;
                }
                const float inv = rcp(fmaxf(l, 1e-20f));
                __nv_bfloat16* dst =
                    o + (((size_t)item.b * S + row) * H + item.h) * HD + st.col;
                // the first HD columns (hd 80: of the pipeline's 128)
#pragma unroll
                for (int c = 0; c < HD / 8; ++c)
                    *reinterpret_cast<uint32_t*>(dst + 8 * c) = pack_bf16(
                        st.acc[4 * c + 2 * i] * inv, st.acc[4 * c + 2 * i + 1] * inv);
            }
        }
    }
}

template <int HD, bool LSE = false>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t S, int64_t T_len, int H, int Kv, int causal, int window,
           cudaStream_t stream, float* lse = nullptr) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, flash_tc_kernel<HD, LSE>);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg only moves registers between the block's warpgroups: the
    // block must start with all that the consumers and the producer take
    if (attr.numRegs * THREADS < 256 * CONSUMER_REGS + 128 * PRODUCER_REGS)
        return (int)cudaErrorInvalidConfiguration;
    constexpr int HP = padded<HD>();
    constexpr int smem = smem_bytes<HP>();
    err = cudaFuncSetAttribute(flash_tc_kernel<HD, LSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    alignas(64) CUtensorMap mq, mk, mv;
    // the maps' hd extent is HD: at hd 80 a box's columns 80-127 come as 0
    if (!encode(fn, &mq, q, B, S, H, HD, BQ) ||
        !encode(fn, &mk, k, B, T_len, Kv, HD, Tile<HP>::BK) ||
        !encode(fn, &mv, v, B, T_len, Kv, HD, Tile<HP>::BK))
        return (int)cudaErrorInvalidValue;
    // persistent: one block an SM, each looping over its share of the items
    int device, sms;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int64_t n_work = (S + BQ - 1) / BQ * H * B;
    if (n_work > INT32_MAX) return (int)cudaErrorInvalidValue;
    flash_tc_kernel<HD, LSE><<<(unsigned int)std::min<int64_t>(n_work, sms), THREADS,
                               smem, stream>>>(
        mq, mk, mv, (__nv_bfloat16*)o, lse, (int)B, (int)S, (int)T_len, H, Kv,
        causal, window, 1.4426950408889634f / sqrtf((float)HD));
    return (int)cudaGetLastError();
}

}  // namespace

// The registers a thread, dynamic shared memory and local memory (spills)
// of the kernel at head dim `hd`, as the runtime reports them: the serving
// instance (hd 64, 80, 128, 256), or with `lse` the training instance (hd
// 64, 128 and 256).
extern "C" int pnp_flash_attention_tc_info(int32_t hd, int32_t lse,
                                           int32_t* registers,
                                           int32_t* shared_bytes,
                                           int32_t* local_bytes) {
    cudaFuncAttributes attr;
    cudaError_t err;
    switch (hd * 2 + (lse != 0)) {
        case 128:
            err = cudaFuncGetAttributes(&attr, flash_tc_kernel<64, false>);
            *shared_bytes = smem_bytes<64>();
            break;
        case 129:
            err = cudaFuncGetAttributes(&attr, flash_tc_kernel<64, true>);
            *shared_bytes = smem_bytes<64>();
            break;
        case 160:
            err = cudaFuncGetAttributes(&attr, flash_tc_kernel<80, false>);
            *shared_bytes = smem_bytes<128>();
            break;
        case 256:
            err = cudaFuncGetAttributes(&attr, flash_tc_kernel<128, false>);
            *shared_bytes = smem_bytes<128>();
            break;
        case 257:
            err = cudaFuncGetAttributes(&attr, flash_tc_kernel<128, true>);
            *shared_bytes = smem_bytes<128>();
            break;
        case 512:
            err = cudaFuncGetAttributes(&attr, flash_tc_kernel<256, false>);
            *shared_bytes = smem_bytes<256>();
            break;
        case 513:
            err = cudaFuncGetAttributes(&attr, flash_tc_kernel<256, true>);
            *shared_bytes = smem_bytes<256>();
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    *local_bytes = (int32_t)attr.localSizeBytes;
    return 0;
}

// q: (B, S, H, hd); k, v: (B, T, Kv, hd); out: (B, S, H, hd); bfloat16,
// contiguous, each starting on a 16-byte boundary. hd in {64, 80, 128, 256};
// H % Kv == 0; window 0 for none. Launches on `stream` and returns
// cudaGetLastError() (or the error that kept it from launching).
extern "C" int pnp_flash_attention_tc_fwd(const void* q, const void* k,
                                          const void* v, void* out, int64_t B,
                                          int64_t S, int64_t T, int32_t H,
                                          int32_t Kv, int32_t hd, int32_t causal,
                                          int32_t window, void* stream) {
    if (B < 0 || S < 0 || T < 1 || H < 1 || Kv < 1 || H % Kv || window < 0 ||
        S > INT32_MAX || T > INT32_MAX || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
        return (int)cudaErrorMisalignedAddress;
    if (B == 0 || S == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
        case 64: return launch<64>(q, k, v, out, B, S, T, H, Kv, causal, window, st);
        case 80: return launch<80>(q, k, v, out, B, S, T, H, Kv, causal, window, st);
        case 128: return launch<128>(q, k, v, out, B, S, T, H, Kv, causal, window, st);
        case 256: return launch<256>(q, k, v, out, B, S, T, H, Kv, causal, window, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The training forward: as pnp_flash_attention_tc_fwd at hd 64, 128 or 256, and
// also each row's log-sum-exp of its scaled scores into lse, float32 (B, H,
// S), natural-log units (-1e30 for a row that sees no key).
extern "C" int pnp_flash_attention_tc_fwd_lse(const void* q, const void* k,
                                              const void* v, void* out, void* lse,
                                              int64_t B, int64_t S, int64_t T,
                                              int32_t H, int32_t Kv, int32_t hd,
                                              int32_t causal, int32_t window,
                                              void* stream) {
    if (B < 0 || S < 0 || T < 1 || H < 1 || Kv < 1 || H % Kv || window < 0 ||
        S > INT32_MAX || T > INT32_MAX || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
        return (int)cudaErrorMisalignedAddress;
    if (B == 0 || S == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    float* l = (float*)lse;
    switch (hd) {
        case 64: return launch<64, true>(q, k, v, out, B, S, T, H, Kv, causal, window, st, l);
        case 128: return launch<128, true>(q, k, v, out, B, S, T, H, Kv, causal, window, st, l);
        case 256: return launch<256, true>(q, k, v, out, B, S, T, H, Kv, causal, window, st, l);
        default: return (int)cudaErrorInvalidValue;
    }
}
