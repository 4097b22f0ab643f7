// Attention backward on the CUDA cores, in float32 FMAs: dQ, dK and dV of
// the attention flash_attention.cu computes, from q, k, v, its output o,
// the output's gradient dO and the row log-sum-exp its training instance
// saves.
//
// Replaces no TPU kernel: the reference has no Pallas backward; jax.grad
// differentiates repro.models.attention.chunked_attention (the function of
// the Pallas forward, src/repro/kernels/flash_attention.py:28). The port's
// training step (models/attention.py self_attention, through
// kernels/flash_attention.py's autograd Function) runs it once a layer and
// microstep.
//
// q, o, dO, dQ (B, S, H, hd); k, v, dK, dV (B, T, Kv, hd); lse (B, H, S);
// all float32, contiguous, 16-byte aligned. Scores are scaled by
// 1/sqrt(hd); with `causal` query s sees keys t <= s (queries at offset 0);
// with `window` > 0 only keys t > s - window. Query head h reads KV head
// h / (H / Kv). The work, per (query s, key t) pair the mask keeps:
//   P = exp(q.k / sqrt(hd) - lse_s), D_s = dO_s . o_s,
//   dV_t += P dO_s,  dP = dO_s . v_t,  dS = P (dP - D_s),
//   dQ_s += dS k_t / sqrt(hd),  dK_t += dS q_s / sqrt(hd).
//
// What bounds it on an H100: operations. The five products (QK^T, dO V^T,
// P^T dO, dS^T Q, dS K) are hd FMAs each per kept pair; at qwen3-0.6b's
// shape (S = T = 2048, hd 128, causal) that is 5.1 ms at the 67 TFLOP/s of
// float32 FMAs outside the tensor cores (no TF32: it would change the
// numbers), against 0.1 ms of bytes. Feeding the FMAs is the hard part, as
// in the forward (flash_attention.cu): an SM's shared memory hands its lanes
// ~128 bytes a cycle against 128 FMAs a cycle, so each float a lane loads
// must feed ~4 FMAs. The design, three launches:
// - dot_kernel: D = rowsum(dO o) of every row (its 16 lanes, a fixed
//   shuffle tree) into the workspace;
// - dkv_kernel: a block owns BK = TM x WARPS keys of one (batch row, KV
//   head), keeps their K and V in shared memory, and walks (query tile,
//   head of the group) pairs, query tiles in descending order and the
//   group's heads inside. Each pair's Q, dO, lse and D come by cp.async
//   (16-byte pieces, zero-filled past S) into a ring of STAGES buffers,
//   issued STAGES - 1 pairs ahead: one barrier a pair. The two halves of a
//   warp share its TM keys and split the work: lanes ty = 0 compute S^T =
//   K Q^T, P and dV += P^T dO, lanes ty = 1 dP^T = V dO^T, dS = P (dP - D)
//   (P from the partner lane by a shuffle) and dK += dS^T Q. Register
//   micro-tiles: lane tx owns TM keys by the queries tx + 16 n of a score
//   tile, and TM keys by the columns VW tx + 16 VW c of its accumulator;
//   its key rows are 16-byte loads that one half-warp shares (broadcasts),
//   so a load of K or V feeds 4 BQ / 16 FMAs and a load of Q or dO feeds 4
//   TM. P and dS reach the product through shared memory 32 queries at a
//   time (each warp its own rows, ordered by __syncwarp). Rows are padded
//   by 4 floats (P and dS chunks by 16, the two 16 floats apart in banks),
//   so no load or store of a tile has a bank conflict. The ty = 1 lanes
//   also store each pair's dS^T (BK x BQ) to the workspace, 16 neighbouring
//   floats a half-warp store: 1.1 GB at qwen3-0.6b's shape, written once;
// - dq_kernel: a block owns one query tile and walks the key tiles that
//   see it in ascending order, their dS^T tiles and K tiles by cp.async in
//   a ring, one barrier a tile: dQ = dS K / sqrt(hd), each lane 8
//   neighbouring rows (two 16-byte broadcasts of dS^T a key) by hd / 16
//   columns. So S and dP are computed once (5 products, the bound's), and
//   dS makes one round trip through device memory instead of two more
//   products. Past the caller's cap on dS (ds_cap_bytes: 2 GiB in the
//   wrapper) the key tiles go in chunks, a dkv_kernel and a dq_kernel
//   each, dQ summed chunk by chunk in order;
// - blocks are issued heaviest causal tile first (the first key tile, the
//   last query tile); causal blocks stop at the diagonal, windowed blocks
//   start at the first tile inside their band;
// - scores are scaled by 1/sqrt(hd) log2(e) in one FMA with -lse log2(e)
//   and exponentiated in base 2; the mask is applied only on tiles that
//   cross the diagonal, the window's edge or the end of S or T;
// - GQA and MQA by index, with no repeated copy of K and V.
// Every sum runs in one fixed order with no atomics (dK and dV over the
// group's heads and query tiles in the loop's order, dQ over key tiles in
// ascending order), so two launches give the same bits and a miner and its
// verifier agree. chip_probes.py's flash_bwd_tiles sweep builds this file
// at other -D BWD_* tiles; the path's tiles are the sweep's fastest at
// qwen3-0.6b's shape, and tie within the spread at pnpcoin-demo's. The
// design beat two others there (PERF.md): two passes that each compute S
// and dP (7 products, no dS in memory), and dQ summed inside the key pass
// in order of key tile through flags.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int PK = 32;          // columns of a P or dS chunk
constexpr int PS = PK + 16;     // P and dS chunk row stride

// Columns a 16-byte (8 at hd 32, 4 at hd 16) load of an accumulator's
// operand covers.
template <int HD>
struct Cols {
    static constexpr int VW = HD == 16 ? 1 : HD == 32 ? 2 : 4;
    static constexpr int VC = HD / (16 * VW);   // loads a row
    static constexpr int LD = HD + 4;           // Q, K, V, dO row stride
};

// dkv_kernel's tile: warps a block, keys a warp (and a lane), queries a
// tile, buffers in the Q/dO ring.
template <int HD>
struct DkvTile : Cols<HD> {
#ifdef BWD_DKV_WARPS
    static constexpr int WARPS = BWD_DKV_WARPS, TM = BWD_DKV_TM,
                         BQ = BWD_DKV_BQ, STAGES = BWD_DKV_STAGES;
#else
    // the sweep's fastest: at hd 64 and 128 the largest tile whose K, V
    // and two stages of Q and dO fit shared memory with 8 warps; at hd 16
    // and 32 (pnpcoin-micro and pnpcoin-demo, S = 16 and 32: a launch's
    // latency) small tiles
    static constexpr int WARPS = HD <= 32 ? 2 : 8;
    static constexpr int TM = 8;
    static constexpr int BQ = HD <= 32 ? 32 : 64;
    static constexpr int STAGES = 2;
#endif
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int BK = TM * WARPS;            // keys a block
    static constexpr int TN = BQ / 16;               // queries a lane
    static constexpr int LD = Cols<HD>::LD;
    // P and dS chunks 16 floats apart in banks: the two halves of a warp
    // store them at once
    static constexpr int SMEM =
        4 * (2 * BK * LD + STAGES * (2 * BQ * LD + 2 * BQ) + 2 * BK * PS +
             16);
    static_assert(BQ % PK == 0 && STAGES >= 2, "dkv tile");
    static_assert(SMEM <= 227 * 1024, "dkv tile fits shared memory");
};

// dq_kernel's tile: a block owns one of dkv_kernel's query
// tiles (BQ rows, 2 TM = 16 a warp) and walks its key tiles of BK keys;
// buffers in the dS^T and K ring.
template <int HD>
struct DqsTile : Cols<HD> {
    using K = DkvTile<HD>;
#ifdef BWD_DQS_STAGES
    static constexpr int STAGES = BWD_DQS_STAGES;
#else
    static constexpr int STAGES = 2;
#endif
    static constexpr int TM = 8;                     // rows a lane
    static constexpr int BQ = K::BQ, BK = K::BK;
    static constexpr int WARPS = BQ / (2 * TM);
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int LD = Cols<HD>::LD;
    static constexpr int SS = BQ + 4;                // dS^T row stride
    static constexpr int SMEM = 4 * STAGES * (BK * SS + BK * LD);
    static_assert(BQ % (2 * TM) == 0 && BK % 4 == 0 && STAGES >= 2,
                  "dq tile");
    static_assert(SMEM <= 227 * 1024, "dq tile fits shared memory");
};

// The query tiles (of BQ rows) that see a key of key tile kt (of BK keys):
// causal rows from its first key on, windowed rows before its last key +
// window; [qt_first, qt_first + n_pair_tiles).
__host__ __device__ __forceinline__ int qt_first_of(int kt, int BK, int BQ,
                                                    int causal) {
    return causal ? kt * BK / BQ : 0;
}

__host__ __device__ __forceinline__ int n_pair_tiles(int kt, int BK, int BQ,
                                                     int S, int T, int causal,
                                                     int window) {
    const int n_qt = (S + BQ - 1) / BQ;
    const int k_last = (kt * BK + BK < T ? kt * BK + BK : T) - 1;
    const int band = (k_last + window - 1) / BQ + 1;
    const int end = window > 0 && band < n_qt ? band : n_qt;
    const int n = end - qt_first_of(kt, BK, BQ, causal);
    return n > 0 ? n : 0;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    const int bytes = valid ? 16 : 0;   // 0: zero-fill, nothing read
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    const int bytes = valid ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a (., heads, HD) tensor, row r at base + r *
// stride floats, into dst[ROWS][HD + 4] by cp.async; rows at or past n are
// zero. The caller commits the group.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* base,
                                           size_t stride, int r0, int n) {
    constexpr int CPR = HD / 4, LD = HD + 4;   // 16-byte pieces a row
#pragma unroll 4
    for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
        const int r = c / CPR, col = (c % CPR) * 4;
        const bool valid = r0 + r < n;
        cp_async16(dst + r * LD + col,
                   valid ? base + (size_t)(r0 + r) * stride + col : base,
                   valid);
    }
}

// src[r0, r0 + ROWS) into dst[ROWS] by 4-byte cp.async; past n zero.
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_scalars(float* dst, const float* src,
                                              int r0, int n) {
    for (int r = threadIdx.x; r < ROWS; r += THREADS) {
        const bool valid = r0 + r < n;
        cp_async4(dst + r, valid ? src + r0 + r : src, valid);
    }
}

template <int VW>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
    if constexpr (VW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
    } else if constexpr (VW == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        out[0] = t.x; out[1] = t.y;
    } else {
        out[0] = p[0];
    }
}

template <int VW>
__device__ __forceinline__ void load_cols_global(const float* p, float* out) {
    if constexpr (VW == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
    } else if constexpr (VW == 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(p));
        out[0] = t.x; out[1] = t.y;
    } else {
        out[0] = __ldg(p);
    }
}

template <int VW>
__device__ __forceinline__ void store_cols(float* p, const float* x) {
    if constexpr (VW == 4)
        *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    else if constexpr (VW == 2)
        *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
    else
        p[0] = x[0];
}

__device__ __forceinline__ float lane_of(const float4& x, int i) {
    return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ bool kept(int qp, int kp, int S, int T, int causal,
                                     int window) {
    return qp < S && kp < T && (!causal || kp <= qp) &&
           (window <= 0 || kp > qp - window);
}

// Whether a (query tile, key tile) pair holds a pair the mask drops.
__device__ __forceinline__ bool edge_tile(int q0, int BQ, int k0, int BK,
                                          int S, int T, int causal,
                                          int window) {
    return q0 + BQ > S || k0 + BK > T || (causal && k0 + BK - 1 > q0) ||
           (window > 0 && k0 <= q0 + BQ - 1 - window);
}

// acc[i][cols] += sum over the chunk's PK columns n of X[row0 + RS i][n]
// Y[n][cols], X the chunk in shared memory (rows of stride PS, 16-byte
// broadcasts), Y at y (row n at y + n * LD, the lane's columns from there),
// n in order.
template <int TM, int RS, int VW, int VC, int LD>
__device__ __forceinline__ void chunk_product(const float* xs, int row0,
                                              const float* y,
                                              float (&acc)[TM][VC * VW]) {
#pragma unroll 4
    for (int n = 0; n < PK; n += 4) {
        float4 xf[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
            xf[i] = *reinterpret_cast<const float4*>(xs + (row0 + RS * i) * PS
                                                     + n);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int c = 0; c < VC; ++c) {
                float yf[VW];
                load_cols<VW>(y + (n + u) * LD + 16 * VW * c, yf);
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const float x = lane_of(xf[i], u);
#pragma unroll
                    for (int e = 0; e < VW; ++e)
                        acc[i][VW * c + e] = fmaf(x, yf[e],
                                                  acc[i][VW * c + e]);
                }
            }
        }
    }
}

// s[i][j] += X[row0 + RS i] . Y[tx + 16 j] over HD, X and Y row-major
// tiles of stride LD in shared memory (X rows broadcast, Y rows one a
// lane).
template <int TM, int RS, int TN, int HD, int LD>
__device__ __forceinline__ void score_product(const float* xs, int row0,
                                              const float* ys, int tx,
                                              float (&s)[TM][TN]) {
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
        float4 xf[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
            xf[i] = *reinterpret_cast<const float4*>(xs + (row0 + RS * i) * LD
                                                     + d);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const float4 yf = *reinterpret_cast<const float4*>(
                ys + (tx + 16 * j) * LD + d);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                s[i][j] = fmaf(xf[i].x, yf.x, s[i][j]);
                s[i][j] = fmaf(xf[i].y, yf.y, s[i][j]);
                s[i][j] = fmaf(xf[i].z, yf.z, s[i][j]);
                s[i][j] = fmaf(xf[i].w, yf.w, s[i][j]);
            }
        }
    }
}

// The key pass: dK and dV of one key tile, and each (query tile, head)
// pair's dS^T into the workspace for dq_kernel.
template <int HD>
__global__ void __launch_bounds__(DkvTile<HD>::THREADS, 1)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ lse,
           const float* __restrict__ dout, const float* __restrict__ Dws,
           float* __restrict__ dk, float* __restrict__ dv,
           float* __restrict__ dsw,
           int kt_a, int64_t chunk_tiles, int S, int T, int H, int Kv,
           int causal, int window, float scale_log2, float scale) {
    using C = DkvTile<HD>;
    constexpr int TM = C::TM, TN = C::TN, VW = C::VW, VC = C::VC;
    constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NS = C::STAGES;
    constexpr int THREADS = C::THREADS;
    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;                   // [BK][LD]
    float* Vs = Ks + BK * LD;           // [BK][LD]
    float* Qs = Vs + BK * LD;           // [NS][BQ][LD]
    float* dOs = Qs + NS * BQ * LD;     // [NS][BQ][LD]
    float* Ls = dOs + NS * BQ * LD;     // [NS][BQ]: lse
    float* Ds = Ls + NS * BQ;           // [NS][BQ]: D
    float* Ps = Ds + NS * BQ;           // [BK][PS]: P chunks
    float* dSs = Ps + BK * PS + 16;     // [BK][PS]: dS chunks

    // the two halves of a warp share its TM keys and split the work: ty 0
    // computes S, P and dV, ty 1 dP, dS and dK, each as a TM x BQ / 16
    // tile a lane (twice the rows of a lane that computed both)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tx = lane & 15, ty = lane >> 4;
    const int row0 = warp * TM;                     // keys row0 + i
    const int kt = kt_a + blockIdx.x;   // heaviest (first) key tile first
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int k0 = kt * BK;
    const int G = H / Kv;
    const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)Kv * HD;
    const float* kb = k + ((size_t)b * T * Kv + kvh) * HD;
    const float* vb = v + ((size_t)b * T * Kv + kvh) * HD;

    // the query tiles that see a key of this tile, walked last tile first,
    // the group's heads inside
    const int qt_first = qt_first_of(kt, BK, BQ, causal);
    const int n_pt = n_pair_tiles(kt, BK, BQ, S, T, causal, window);
    const int qt_end = qt_first + n_pt;
    const int count = n_pt * G;
    // where this key tile's dS goes: a (batch row, head) holds chunk_tiles
    // tiles of BK x BQ, key tile by key tile from kt_a, each key tile's
    // [BK][n_pt BQ] (its query tiles side by side)
    int64_t off_kt = 0;
    for (int t = kt_a; t < kt; ++t)
        off_kt += n_pair_tiles(t, BK, BQ, S, T, causal, window);
    const size_t ds_row = (size_t)n_pt * BQ;

    auto stage_pair = [&](int j, int slot) {
        const int qt = qt_end - 1 - j / G, h = kvh * G + j % G;
        const int q0 = qt * BQ;
        const size_t rows = ((size_t)b * H + h) * S;
        stage_rows<HD, BQ, THREADS>(Qs + slot * BQ * LD,
                                    q + ((size_t)b * S * H + h) * HD,
                                    q_stride, q0, S);
        stage_rows<HD, BQ, THREADS>(dOs + slot * BQ * LD,
                                    dout + ((size_t)b * S * H + h) * HD,
                                    q_stride, q0, S);
        stage_scalars<BQ, THREADS>(Ls + slot * BQ, lse + rows, q0, S);
        stage_scalars<BQ, THREADS>(Ds + slot * BQ, Dws + rows, q0, S);
    };

    // K and V, then pairs 0 .. NS - 2: one commit group each
    stage_rows<HD, BK, THREADS>(Ks, kb, kv_stride, k0, T);
    stage_rows<HD, BK, THREADS>(Vs, vb, kv_stride, k0, T);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j + 1 < NS; ++j) {
        if (j < count) stage_pair(j, j);
        cp_async_commit();
    }

    // dV (ty 0) or dK (ty 1) of the warp's keys, the lane's columns
    float acc[TM][VC * VW];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < VC * VW; ++c) acc[i][c] = 0.f;

    for (int j = 0; j < count; ++j) {
        const int slot = j % NS;
        const int qt = qt_end - 1 - j / G, h = kvh * G + j % G;
        const int q0 = qt * BQ;
        cp_async_wait<NS - 2>();        // pair j landed
        __syncthreads();                // ... for every thread; pair j - 1
                                        // is done with its buffers
        {
            const int jn = j + NS - 1;
            if (jn < count) stage_pair(jn, jn % NS);
            cp_async_commit();
        }
        const float* Qt = Qs + slot * BQ * LD;
        const float* Gt = dOs + slot * BQ * LD;
        const float* Lt = Ls + slot * BQ;
        const float* Dt = Ds + slot * BQ;

        // ty 0: S^T = K Q^T; ty 1: dP^T = V dO^T. Lane rows are the warp's
        // keys, its columns the queries tx + 16 n
        float s[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int n = 0; n < TN; ++n) s[i][n] = 0.f;
        score_product<TM, 1, TN, HD, LD>(ty ? Vs : Ks, row0, ty ? Gt : Qt,
                                         tx, s);

        // P on both halves (ty 0's is the one kept; ty 1 takes it from its
        // partner lane, which holds the same keys and queries), then dS
        const bool edge = edge_tile(q0, BQ, k0, BK, S, T, causal, window);
#pragma unroll
        for (int n = 0; n < TN; ++n) {
            const int qi = tx + 16 * n;
            const float l2 = Lt[qi] * LOG2E, dd = Dt[qi];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const bool keep = !edge || kept(q0 + qi, k0 + row0 + i, S, T,
                                                causal, window);
                const float p =
                    keep ? exp2f(fmaf(s[i][n], scale_log2, -l2)) : 0.f;
                const float p0 = __shfl_xor_sync(0xffffffffu, p, 16);
                s[i][n] = ty ? p0 * (s[i][n] - dd) : p;
            }
        }

        // dS^T of the pair to device memory for dq_kernel (16 neighbouring
        // floats a half-warp store)
        if (ty) {
            float* dst = dsw
                         + (((size_t)b * H + h) * chunk_tiles + off_kt)
                               * (BK * BQ)
                         + (size_t)(qt - qt_first) * BQ
                         + (size_t)row0 * ds_row + tx;
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int n = 0; n < TN; ++n)
                    dst[i * ds_row + 16 * n] = s[i][n];
        }

        // ty 0: dV += P^T dO; ty 1: dK += dS^T Q. PK queries at a time:
        // the warp's P and dS rows of those queries into shared memory
        // (only this warp reads them), queries in order
        float* Xc = ty ? dSs : Ps;
        const float* Yt = (ty ? Qt : Gt) + VW * tx;
#pragma unroll
        for (int c = 0; c < BQ / PK; ++c) {
            __syncwarp();
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int n = 0; n < PK / 16; ++n)
                    Xc[(row0 + i) * PS + tx + 16 * n] =
                        s[i][c * (PK / 16) + n];
            __syncwarp();
            chunk_product<TM, 1, VW, VC, LD>(Xc, row0, Yt + c * PK * LD,
                                             acc);
        }
    }
    cp_async_wait<0>();                 // no copy outlives the block

    float* dst = ty ? dk : dv;
    const float mult = ty ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int key = k0 + row0 + i;
        if (key >= T) continue;
        const size_t off = ((size_t)b * T + key) * kv_stride
                           + (size_t)kvh * HD + VW * tx;
#pragma unroll
        for (int c = 0; c < VC; ++c) {
            float x[VW];
#pragma unroll
            for (int e = 0; e < VW; ++e) x[e] = acc[i][VW * c + e] * mult;
            store_cols<VW>(dst + off + 16 * VW * c, x);
        }
    }
}

// The dQ pass: dQ = dS K / sqrt(hd) from the dS^T tiles dkv_kernel
// stored. A block owns one query tile (BQ rows) of one (batch row, head)
// and walks the key tiles of [kt_a, kt_b) that see it, in ascending order;
// each tile's dS^T (BK x BQ) and K (BK x HD) come by cp.async into a ring
// of STAGES buffers, STAGES - 1 tiles ahead: one barrier a tile. Lane (ty,
// tx) of a warp owns its TM = 8 neighbouring rows (warp rows + 8 ty) and
// columns VW tx + 16 VW c: per key, two 16-byte broadcasts of dS^T and
// VC loads of K feed TM hd / 16 FMAs. With `accumulate` (a later chunk of
// key tiles) the sum is added to dq's; rows no tile of the chunk sees
// keep dq's value, and the first chunk writes every row.
template <int HD>
__global__ void __launch_bounds__(DqsTile<HD>::THREADS, 1)
dq_kernel(const float* __restrict__ k, const float* __restrict__ dsw,
          float* __restrict__ dq, int S, int T, int H, int Kv, int causal,
          int window, int kt_a, int kt_b, int64_t chunk_tiles,
          int accumulate, float scale) {
    using C = DqsTile<HD>;
    constexpr int TM = C::TM, VW = C::VW, VC = C::VC, BQ = C::BQ, BK = C::BK;
    constexpr int LD = C::LD, SS = C::SS, NS = C::STAGES;
    constexpr int THREADS = C::THREADS;
    extern __shared__ __align__(16) float smem[];
    float* dSt = smem;                  // [NS][BK][SS]
    float* Ks = dSt + NS * BK * SS;     // [NS][BK][LD]

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tx = lane & 15, ty = lane >> 4;
    const int row0 = warp * 2 * TM + ty * TM;       // rows row0 + i
    const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest first
    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = qt * BQ;
    const int kvh = h / (H / Kv);
    const size_t kv_stride = (size_t)Kv * HD;
    const float* kb = k + ((size_t)b * T * Kv + kvh) * HD;

    // the run of key tiles in [kt_a, kt_b) that see this query tile, and
    // where the first one's dS^T lies
    int first = 0, count = 0;
    int64_t off = 0, off_first = 0;
    for (int t = kt_a; t < kt_b; ++t) {
        const int n = n_pair_tiles(t, BK, BQ, S, T, causal, window);
        const int qf = qt_first_of(t, BK, BQ, causal);
        if (qt >= qf && qt < qf + n) {
            if (count == 0) {
                first = t;
                off_first = off;
            }
            ++count;
        }
        off += n;
    }
    const float* ds_bh =
        dsw + ((size_t)b * H + h) * chunk_tiles * (BK * BQ);

    // tile j's dS^T and K into slot j % NS; `off_load` walks the offsets of
    // the tiles in the order they are staged
    int64_t off_load = off_first;
    auto stage = [&](int j) {
        const int t = first + j;
        const int n = n_pair_tiles(t, BK, BQ, S, T, causal, window);
        const size_t row = (size_t)n * BQ;
        const float* src = ds_bh + off_load * (BK * BQ)
                           + (size_t)(qt - qt_first_of(t, BK, BQ, causal))
                                 * BQ;
        float* dst = dSt + (j % NS) * BK * SS;
        constexpr int CPR = BQ / 4;     // 16-byte pieces a row
        for (int c = threadIdx.x; c < BK * CPR; c += THREADS) {
            const int r = c / CPR, col = (c % CPR) * 4;
            cp_async16(dst + r * SS + col, src + r * row + col, true);
        }
        stage_rows<HD, BK, THREADS>(Ks + (j % NS) * BK * LD, kb, kv_stride,
                                    t * BK, T);
        off_load += n;
    };
#pragma unroll
    for (int j = 0; j + 1 < NS; ++j) {
        if (j < count) stage(j);
        cp_async_commit();
    }

    float acc[TM][VC * VW];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < VC * VW; ++c) acc[i][c] = 0.f;
    for (int j = 0; j < count; ++j) {
        cp_async_wait<NS - 2>();        // tile j landed
        __syncthreads();                // ... for every thread; tile j - 1
                                        // is done with its buffers
        if (j + NS - 1 < count) stage(j + NS - 1);
        cp_async_commit();
        const float* xs = dSt + (j % NS) * BK * SS + row0;
        const float* ys = Ks + (j % NS) * BK * LD + VW * tx;
#pragma unroll 4
        for (int n = 0; n < BK; ++n) {
            const float4 x0 = *reinterpret_cast<const float4*>(xs + n * SS);
            const float4 x1 =
                *reinterpret_cast<const float4*>(xs + n * SS + 4);
            const float x[TM] = {x0.x, x0.y, x0.z, x0.w,
                                 x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int c = 0; c < VC; ++c) {
                float yf[VW];
                load_cols<VW>(ys + n * LD + 16 * VW * c, yf);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int e = 0; e < VW; ++e)
                        acc[i][VW * c + e] =
                            fmaf(x[i], yf[e], acc[i][VW * c + e]);
            }
        }
    }
    cp_async_wait<0>();                 // no copy outlives the block

    if (accumulate && count == 0) return;
    const size_t q_stride = (size_t)H * HD;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int qp = q0 + row0 + i;
        if (qp >= S) continue;
        float* dst = dq + ((size_t)b * S + qp) * q_stride + (size_t)h * HD
                     + VW * tx;
#pragma unroll
        for (int c = 0; c < VC; ++c) {
            float x[VW];
            if (accumulate) load_cols<VW>(dst + 16 * VW * c, x);
#pragma unroll
            for (int e = 0; e < VW; ++e)
                x[e] = accumulate ? x[e] + acc[i][VW * c + e] * scale
                                  : acc[i][VW * c + e] * scale;
            store_cols<VW>(dst + 16 * VW * c, x);
        }
    }
}

// The first launch: D = rowsum(dO o) of every row (a row's 16 lanes, a
// fixed shuffle tree) into Dws (B, H, S).
template <int HD>
__global__ void __launch_bounds__(256)
dot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
           float* __restrict__ Dws, int64_t n_rows, int S, int H) {
    constexpr int VW = Cols<HD>::VW, VC = Cols<HD>::VC;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int tx = threadIdx.x & 15;
    const int64_t r = tid >> 4;        // row of (B, S, H) in memory order
    const bool live = r < n_rows;
    float part = 0.f;
    if (live) {
#pragma unroll
        for (int c = 0; c < VC; ++c) {
            float of[VW], gf[VW];
            load_cols_global<VW>(o + r * HD + VW * tx + 16 * VW * c, of);
            load_cols_global<VW>(dout + r * HD + VW * tx + 16 * VW * c, gf);
#pragma unroll
            for (int e = 0; e < VW; ++e) part = fmaf(gf[e], of[e], part);
        }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
    if (!live) return;
    const int h = (int)(r % H);
    const int64_t bs = r / H;
    const int s = (int)(bs % S);
    const int64_t b = bs / S;
    if (tx == 0) Dws[(b * H + h) * S + s] = part;
}

// The chunks of key tiles, each holding at most `cap_bytes` of
// dS^T tiles (or one key tile): calls `chunk(kt_a, kt_b, tiles)` for each,
// in order, and returns the most tiles a chunk holds (tiles of one (batch
// row, head)). A chunk is one dkv_kernel and one dq_kernel launch, and dQ
// is summed chunk by chunk in order.
template <int HD, typename F>
int64_t plan_chunks(int64_t B, int64_t S, int64_t T, int64_t H, int causal,
                    int window, int64_t cap_bytes, F chunk) {
    using K = DkvTile<HD>;
    const int64_t tile_bytes = B * H * K::BK * K::BQ * 4;
    const int64_t cap = cap_bytes / tile_bytes > 0
                            ? cap_bytes / tile_bytes : 1;
    const int n_kt = (int)((T + K::BK - 1) / K::BK);
    int64_t most = 0, tiles = 0;
    int kt_a = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int64_t n = n_pair_tiles(kt, K::BK, K::BQ, (int)S, (int)T,
                                       causal, window);
        if (kt > kt_a && tiles + n > cap) {
            chunk(kt_a, kt, tiles);
            most = tiles > most ? tiles : most;
            kt_a = kt;
            tiles = 0;
        }
        tiles += n;
    }
    chunk(kt_a, n_kt, tiles);
    return tiles > most ? tiles : most;
}

// Words (4 bytes) of D (B, H, S), rounded up to 16 bytes.
inline int64_t d_words(int64_t B, int64_t S, int64_t H) {
    return (B * H * S + 3) / 4 * 4;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* lse, const float* dout, float* dq, float* dk,
           float* dv, float* ws, int64_t B, int64_t S, int64_t T, int H,
           int Kv, int causal, int window, int64_t cap_bytes,
           cudaStream_t stream) {
    using K = DkvTile<HD>;
    using Q = DqsTile<HD>;
    const float scale = 1.f / sqrtf((float)HD);
    const float scale_log2 = LOG2E * scale;
    cudaError_t err = cudaFuncSetAttribute(
        dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Q::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int64_t n_rows = B * S * H;
    const unsigned int dot_blocks = (unsigned int)((n_rows * 16 + 255) / 256);
    dot_kernel<HD><<<dot_blocks, 256, 0, stream>>>(o, dout, ws, n_rows,
                                                   (int)S, H);
    err = cudaGetLastError();
    float* dsw = ws + d_words(B, S, H);
    const dim3 gq((unsigned int)((S + Q::BQ - 1) / Q::BQ), (unsigned int)H,
                  (unsigned int)B);
    int first = 1;
    plan_chunks<HD>(B, S, T, H, causal, window, cap_bytes,
                    [&](int kt_a, int kt_b, int64_t tiles) {
        if (err != cudaSuccess) return;
        const dim3 gk((unsigned int)(kt_b - kt_a), (unsigned int)Kv,
                      (unsigned int)B);
        dkv_kernel<HD><<<gk, K::THREADS, K::SMEM, stream>>>(
            q, k, v, lse, dout, ws, dk, dv, dsw, kt_a, tiles, (int)S, (int)T,
            H, Kv, causal, window, scale_log2, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return;
        dq_kernel<HD><<<gq, Q::THREADS, Q::SMEM, stream>>>(
            k, dsw, dq, (int)S, (int)T, H, Kv, causal, window, kt_a, kt_b,
            tiles, !first, scale);
        err = cudaGetLastError();
        first = 0;
    });
    return (int)err;
}

template <int HD>
int64_t workspace_words(int64_t B, int64_t S, int64_t T, int64_t H,
                        int causal, int window, int64_t cap_bytes) {
    using K = DkvTile<HD>;
    return d_words(B, S, H)
           + plan_chunks<HD>(B, S, T, H, causal, window, cap_bytes,
                             [](int, int, int64_t) {})
                 * B * H * K::BK * K::BQ;
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
    using K = DkvTile<HD>;
    using Q = DqsTile<HD>;
    const int32_t t[8] = {Q::WARPS, Q::BQ, Q::BK, Q::STAGES,
                          K::WARPS, K::BK, K::BQ, K::STAGES};
    for (int i = 0; i < 8; ++i) out[i] = t[i];
    return resources(dot_kernel<HD>, out + 8)
           | resources(dq_kernel<HD>, out + 10)
           | resources(dkv_kernel<HD>, out + 12);
}

}  // namespace

// The workspace pnp_flash_attention_bwd takes at these arguments, in
// 4-byte words: D (B, H, S), then the dS^T tiles of its largest chunk of
// key tiles (a chunk holds at most ds_cap_bytes or one key tile). Negative
// for arguments it does not take.
extern "C" int64_t pnp_flash_attention_bwd_workspace_words(
    int64_t B, int64_t S, int64_t T, int32_t H, int32_t hd, int32_t causal,
    int32_t window, int64_t ds_cap_bytes) {
    if (B < 0 || S < 0 || T < 1 || H < 1 || window < 0 || S > INT32_MAX ||
        T > INT32_MAX)
        return -1;
#define PNP_WS_ARGS B, S, T, H, causal, window, ds_cap_bytes
    switch (hd) {
        case 16: return workspace_words<16>(PNP_WS_ARGS);
        case 32: return workspace_words<32>(PNP_WS_ARGS);
        case 64: return workspace_words<64>(PNP_WS_ARGS);
        case 128: return workspace_words<128>(PNP_WS_ARGS);
        default: return -1;
    }
#undef PNP_WS_ARGS
}

// The tiles at head dim `hd`, as 14 ints: dq_kernel's warps, query rows,
// keys a tile and stages; dkv_kernel's warps, keys, queries a tile and
// stages; then the registers a thread and local (spilled) bytes the runtime
// reports for dot_kernel, dq_kernel and dkv_kernel (-1 where it reports
// none).
extern "C" int pnp_flash_attention_bwd_info(int32_t hd, int32_t* out) {
    switch (hd) {
        case 16: return info<16>(out);
        case 32: return info<32>(out);
        case 64: return info<64>(out);
        case 128: return info<128>(out);
        default: return (int)cudaErrorInvalidValue;
    }
}

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, T, Kv, hd); lse: (B, H,
// S); float32, contiguous, 16-byte aligned; hd in {16, 32, 64, 128}; H % Kv ==
// 0; window 0 for none; ws: pnp_flash_attention_bwd_workspace_words words
// (the kernels initialise it) at the same ds_cap_bytes. Launches on
// `stream` dot_kernel, then a dkv_kernel and a dq_kernel a chunk of key
// tiles; returns cudaGetLastError().
extern "C" int pnp_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* lse, const void* dout,
                                       void* dq, void* dk, void* dv,
                                       void* ws, int64_t B, int64_t S,
                                       int64_t T, int32_t H, int32_t Kv,
                                       int32_t hd, int32_t causal,
                                       int32_t window, int64_t ds_cap_bytes,
                                       void* stream) {
    if (B < 0 || S < 0 || T < 1 || H < 1 || Kv < 1 || H % Kv || window < 0 ||
        S > INT32_MAX || T > INT32_MAX || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || S == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
#define PNP_BWD_ARGS                                                        \
    (const float*)q, (const float*)k, (const float*)v, (const float*)o,     \
        (const float*)lse, (const float*)dout, (float*)dq, (float*)dk,      \
        (float*)dv, (float*)ws, B, S, T, H, Kv, causal, window,            \
        ds_cap_bytes, st
    switch (hd) {
        case 16: return launch<16>(PNP_BWD_ARGS);
        case 32: return launch<32>(PNP_BWD_ARGS);
        case 64: return launch<64>(PNP_BWD_ARGS);
        case 128: return launch<128>(PNP_BWD_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef PNP_BWD_ARGS
}
