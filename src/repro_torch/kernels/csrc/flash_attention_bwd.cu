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
// q, o, dO, dQ (B, S, H, hd); k, v, dK, dV (B, T, Kv, hd); lse and the
// workspace D (B, H, S); all float32, contiguous. Scores are scaled by
// 1/sqrt(hd); with `causal` query s sees keys t <= s (queries at offset 0);
// with `window` > 0 only keys t > s - window. Query head h reads KV head
// h / (H / Kv). The work, per (query s, key t) pair the mask keeps:
//   P = exp(q.k / sqrt(hd) - lse_s), D_s = dO_s . o_s,
//   dV_t += P dO_s,  dP = dO_s . v_t,  dS = P (dP - D_s),
//   dQ_s += dS k_t / sqrt(hd),  dK_t += dS q_s / sqrt(hd).
//
// Two launches, and no atomics, so every sum runs in one fixed order and
// two launches give the same bits (a miner and its verifier must agree):
// - dq_kernel: a block per (query tile of BQ rows, head, batch row) first
//   computes D for its rows (a warp a row, a fixed shuffle tree) and writes
//   it to the workspace, then walks the key tiles its rows see in ascending
//   order, accumulating dQ in registers;
// - dkv_kernel (after it, on the same stream): a block per (key tile of BK
//   keys, KV head, batch row) walks its G query heads in order, and for
//   each the query tiles that see the tile in ascending order, accumulating
//   dK and dV in registers; dK and dV sum over the G heads of the group.
// Tiles go through shared memory (rows padded to hd + 1 floats, so the
// column walks of the products hit 32 different banks). A thread owns one
// row (or key) of a product and every 8th column: the 8 threads of a row
// read one address of the shared operand (a broadcast) and 8 neighbouring
// columns of the other. Simple, and right; not yet tuned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 32;          // query rows a tile
constexpr int BK = 32;          // keys a tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;   // threads a row of a product (8)
constexpr int PS = BK + 1;      // P and dS row stride
static_assert(BQ == BK, "one thread map serves both tile shapes");

template <int HD>
struct Smem {
    static constexpr int LD = HD + 1;
    // dq_kernel: Q, dO (BQ rows), K, V (BK rows), dS; lse and D of its rows
    static constexpr int DQ = 4 * (2 * BQ * LD + 2 * BK * LD + BQ * PS + 2 * BQ);
    // dkv_kernel: K, V, Q, dO, P, dS; lse and D
    static constexpr int DKV =
        4 * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * PS + 2 * BQ);
};

// Rows [r0, r0 + n_rows) of a (., heads, HD) tensor at base, row stride
// `stride` elements, into dst[BQ][HD + 1]; rows at or past n are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          size_t stride, int r0, int n) {
    constexpr int LD = HD + 1;
    for (int c = threadIdx.x; c < BQ * HD; c += THREADS) {
        const int r = c / HD, col = c % HD;
        dst[r * LD + col] =
            r0 + r < n ? base[(size_t)(r0 + r) * stride + col] : 0.f;
    }
}

__device__ __forceinline__ bool kept(int qp, int kp, int S, int T, int causal,
                                     int window) {
    return qp < S && kp < T && (!causal || kp <= qp) &&
           (window <= 0 || kp > qp - window);
}

// Scores and dP of a (BQ x BK) tile: thread t owns row r = t / TPR and keys
// c = t % TPR + TPR j. Writes P (and dS) of its keys into shared memory.
template <int HD>
__device__ __forceinline__ void tile_products(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* D_s, float* Ps, float* dSs, int q0,
    int k0, int S, int T, int causal, int window, float scale_log2) {
    constexpr int LD = HD + 1, NJ = BK / TPR;
    const int r = threadIdx.x / TPR, c0 = threadIdx.x % TPR;
    float s[NJ], dp[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
        const float qv = Qs[r * LD + d], gv = dOs[r * LD + d];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int c = c0 + TPR * j;
            s[j] = fmaf(qv, Ks[c * LD + d], s[j]);
            dp[j] = fmaf(gv, Vs[c * LD + d], dp[j]);
        }
    }
    const float lse2 = lse_s[r] * LOG2E, dr = D_s[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int c = c0 + TPR * j;
        const float p = kept(q0 + r, k0 + c, S, T, causal, window)
                            ? exp2f(fmaf(s[j], scale_log2, -lse2))
                            : 0.f;
        if (Ps != nullptr) Ps[r * PS + c] = p;
        dSs[r * PS + c] = p * (dp[j] - dr);
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ lse, const float* __restrict__ dout,
          float* __restrict__ dq, float* __restrict__ Dws, int S, int T,
          int H, int Kv, int causal, int window, float scale_log2,
          float scale) {
    constexpr int LD = HD + 1, NC = HD / TPR;
    extern __shared__ float smem[];
    float* Qs = smem;
    float* dOs = Qs + BQ * LD;
    float* Ks = dOs + BQ * LD;
    float* Vs = Ks + BK * LD;
    float* dSs = Vs + BK * LD;
    float* lse_s = dSs + BQ * PS;
    float* D_s = lse_s + BQ;

    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / Kv);
    const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)Kv * HD;
    const float* qb = q + ((size_t)b * S * H + h) * HD;
    const float* ob = o + ((size_t)b * S * H + h) * HD;
    const float* gb = dout + ((size_t)b * S * H + h) * HD;
    const float* kb = k + ((size_t)b * T * Kv + kvh) * HD;
    const float* vb = v + ((size_t)b * T * Kv + kvh) * HD;
    const size_t row0 = ((size_t)b * H + h) * S;

    // D of the tile's rows: a warp a row, lanes over columns, then a fixed
    // shuffle tree
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < BQ; r += THREADS / 32) {
        float acc = 0.f;
        if (q0 + r < S)
            for (int d = lane; d < HD; d += 32)
                acc = fmaf(gb[(size_t)(q0 + r) * q_stride + d],
                           ob[(size_t)(q0 + r) * q_stride + d], acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) {
            D_s[r] = acc;
            lse_s[r] = q0 + r < S ? lse[row0 + q0 + r] : 0.f;
            if (q0 + r < S) Dws[row0 + q0 + r] = acc;
        }
    }
    load_tile<HD>(Qs, qb, q_stride, q0, S);
    load_tile<HD>(dOs, gb, q_stride, q0, S);

    const int q_last = min(q0 + BQ, S) - 1;
    int kt_end = (T + BK - 1) / BK;
    if (causal) kt_end = min(kt_end, q_last / BK + 1);
    const int kt_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;

    const int r = threadIdx.x / TPR, c0 = threadIdx.x % TPR;
    float acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] = 0.f;
    for (int kt = kt_first; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();               // the last tile's dS and K are used
        load_tile<HD>(Ks, kb, kv_stride, k0, T);
        load_tile<HD>(Vs, vb, kv_stride, k0, T);
        __syncthreads();
        tile_products<HD>(Qs, dOs, Ks, Vs, lse_s, D_s, nullptr, dSs, q0, k0,
                          S, T, causal, window, scale_log2);
        __syncthreads();
        // dQ[r][cols] += dS[r][c] K[c][cols], keys in order
        for (int c = 0; c < BK; ++c) {
            const float ds = dSs[r * PS + c];
#pragma unroll
            for (int i = 0; i < NC; ++i)
                acc[i] = fmaf(ds, Ks[c * LD + c0 + TPR * i], acc[i]);
        }
    }
    if (q0 + r < S) {
        float* dst = dq + ((size_t)b * S + q0 + r) * q_stride + (size_t)h * HD;
#pragma unroll
        for (int i = 0; i < NC; ++i) dst[c0 + TPR * i] = acc[i] * scale;
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ lse,
           const float* __restrict__ dout, const float* __restrict__ Dws,
           float* __restrict__ dk, float* __restrict__ dv, int S, int T,
           int H, int Kv, int causal, int window, float scale_log2,
           float scale) {
    constexpr int LD = HD + 1, NC = HD / TPR;
    extern __shared__ float smem[];
    float* Ks = smem;
    float* Vs = Ks + BK * LD;
    float* Qs = Vs + BK * LD;
    float* dOs = Qs + BQ * LD;
    float* Ps = dOs + BQ * LD;
    float* dSs = Ps + BQ * PS;
    float* lse_s = dSs + BQ * PS;
    float* D_s = lse_s + BQ;

    const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
    const int G = H / Kv;
    const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)Kv * HD;
    const float* kb = k + ((size_t)b * T * Kv + kvh) * HD;
    const float* vb = v + ((size_t)b * T * Kv + kvh) * HD;
    load_tile<HD>(Ks, kb, kv_stride, k0, T);
    load_tile<HD>(Vs, vb, kv_stride, k0, T);

    // the query tiles that see a key of this tile: causal rows from k0 on,
    // windowed rows before k_last + window
    const int n_qt = (S + BQ - 1) / BQ;
    const int k_last = min(k0 + BK, T) - 1;
    const int qt_first = causal ? k0 / BQ : 0;
    const int qt_end =
        window > 0 ? min(n_qt, (k_last + window - 1) / BQ + 1) : n_qt;

    const int c = threadIdx.x / TPR, c0 = threadIdx.x % TPR;
    float acc_k[NC], acc_v[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc_k[i] = acc_v[i] = 0.f;
    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const float* qb = q + ((size_t)b * S * H + h) * HD;
        const float* gb = dout + ((size_t)b * S * H + h) * HD;
        const size_t row0 = ((size_t)b * H + h) * S;
        for (int qt = qt_first; qt < qt_end; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();           // the last tile's P, dS, Q, dO used
            load_tile<HD>(Qs, qb, q_stride, q0, S);
            load_tile<HD>(dOs, gb, q_stride, q0, S);
            if (threadIdx.x < BQ) {
                const int qp = q0 + threadIdx.x;
                lse_s[threadIdx.x] = qp < S ? lse[row0 + qp] : 0.f;
                D_s[threadIdx.x] = qp < S ? Dws[row0 + qp] : 0.f;
            }
            __syncthreads();
            tile_products<HD>(Qs, dOs, Ks, Vs, lse_s, D_s, Ps, dSs, q0, k0,
                              S, T, causal, window, scale_log2);
            __syncthreads();
            // dV[c][cols] += P[r][c] dO[r][cols]; dK[c][cols] += dS[r][c]
            // Q[r][cols]; rows in order
            for (int r = 0; r < BQ; ++r) {
                const float p = Ps[r * PS + c], ds = dSs[r * PS + c];
#pragma unroll
                for (int i = 0; i < NC; ++i) {
                    acc_v[i] = fmaf(p, dOs[r * LD + c0 + TPR * i], acc_v[i]);
                    acc_k[i] = fmaf(ds, Qs[r * LD + c0 + TPR * i], acc_k[i]);
                }
            }
        }
    }
    if (k0 + c < T) {
        const size_t off = ((size_t)b * T + k0 + c) * kv_stride +
                           (size_t)kvh * HD;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
            dk[off + c0 + TPR * i] = acc_k[i] * scale;
            dv[off + c0 + TPR * i] = acc_v[i];
        }
    }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* lse, const float* dout, float* dq, float* dk,
           float* dv, float* Dws, int64_t B, int64_t S, int64_t T, int H,
           int Kv, int causal, int window, cudaStream_t stream) {
    using M = Smem<HD>;
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, M::DQ);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, M::DKV);
    if (err != cudaSuccess) return (int)err;
    const float scale = 1.f / sqrtf((float)HD);
    const float scale_log2 = LOG2E * scale;
    const dim3 gq((unsigned int)((S + BQ - 1) / BQ), (unsigned int)H,
                  (unsigned int)B);
    dq_kernel<HD><<<gq, THREADS, M::DQ, stream>>>(
        q, k, v, o, lse, dout, dq, Dws, (int)S, (int)T, H, Kv, causal, window,
        scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 gk((unsigned int)((T + BK - 1) / BK), (unsigned int)Kv,
                  (unsigned int)B);
    dkv_kernel<HD><<<gk, THREADS, M::DKV, stream>>>(
        q, k, v, lse, dout, Dws, dk, dv, (int)S, (int)T, H, Kv, causal,
        window, scale_log2, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, T, Kv, hd); lse and the
// workspace D: (B, H, S); float32, contiguous; hd in {32, 64, 128}; H % Kv
// == 0; window 0 for none. Two launches on `stream` (dQ and D, then dK and
// dV); returns cudaGetLastError().
extern "C" int pnp_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* lse, const void* dout,
                                       void* dq, void* dk, void* dv,
                                       void* dws, int64_t B, int64_t S,
                                       int64_t T, int32_t H, int32_t Kv,
                                       int32_t hd, int32_t causal,
                                       int32_t window, void* stream) {
    if (B < 0 || S < 0 || T < 1 || H < 1 || Kv < 1 || H % Kv || window < 0 ||
        S > INT32_MAX || T > INT32_MAX || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || S == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
#define PNP_BWD_ARGS                                                        \
    (const float*)q, (const float*)k, (const float*)v, (const float*)o,     \
        (const float*)lse, (const float*)dout, (float*)dq, (float*)dk,      \
        (float*)dv, (float*)dws, B, S, T, H, Kv, causal, window, st
    switch (hd) {
        case 32: return launch<32>(PNP_BWD_ARGS);
        case 64: return launch<64>(PNP_BWD_ARGS);
        case 128: return launch<128>(PNP_BWD_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef PNP_BWD_ARGS
}
