// Attention forward with an online softmax (flash attention).
//
// Replaces: src/repro/kernels/flash_attention.py `_flash_kernel` /
// `flash_attention_pallas` (reached through `ops.flash_attention`), whose
// function is `repro.models.attention.chunked_attention`'s: every prefill
// layer of a dense model computes it.
//
// q (B, S, H, hd), k and v (B, T, Kv, hd), out (B, S, H, hd), all in one
// dtype (float32 or bfloat16), contiguous. float32 math inside: scores
// scaled by 1/sqrt(hd), masked scores -1e30, out = acc / max(l, 1e-20).
// With `causal`, query s sees keys t <= s (queries at offset 0); with
// `window` > 0 only keys t > s - window (recurrentgemma's local attention).
//
// What bounds it on an H100: operations. At the serve shape (S = T = 2048,
// hd 128) it does 4 hd flops per (query, key) pair against 2 hd bytes of
// q and out per query, far above the card's ~295 flops a byte in bf16.
// This first version runs its products as float32 FMAs on the CUDA cores
// (67 TFLOP/s), not on the tensor cores (989 in bf16): `wgmma`, TMA and a
// warp-specialised pipeline are later work.
//
// What the design does about it:
// - one block of 256 threads per (64-row query tile, head, batch row); the
//   block streams 64-key tiles of K and V through shared memory and keeps
//   the running max, sum and accumulator of its rows in registers, so the
//   (S, T) score matrix never exists. Blocks are issued heaviest (last)
//   causal tile first;
// - GQA by index: query head h reads KV head h / (H / Kv), so no repeated
//   copy of K and V is made;
// - tiles are staged as float32: Q and K transposed ([hd][64]), V row-major,
//   so the inner loops read 16-byte vectors: a thread's 4 x 4 score
//   micro-tile takes two vector loads per 16 FMAs, and its 4 x hd/16 output
//   micro-tile hd/64 V vectors (plus one P vector) per key for hd/4 FMAs.
//   K and V share one buffer (K for the scores, then V), so at hd 128 a
//   block needs 81 KB and two blocks fit an SM. At hd 256 a block needs
//   148 KB and holds 64 accumulators a thread, so it runs one block an SM
//   with the whole register file open to it (no spills);
// - ragged S and T are masked (rows and keys past the end are zero in
//   shared memory and masked in the scores); causal blocks stop at the
//   diagonal tile and never load the tiles above it; windowed blocks start
//   at the first tile that holds a key inside the band of their first row,
//   so at S = 4096 and window 2048 a block reads at most 33 tiles, not 64;
// - MQA and GQA alike: query head h reads KV head h / (H / Kv), so the ten
//   query heads of recurrentgemma share the one K and V in place;
// - one block owns each output row and reduces its keys in a fixed order
//   (fixed shuffle trees, no atomics), so the output is the same from run
//   to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 rows, tx 4 keys / hd/16 cols
constexpr int PS = BK + 4;    // row stride of the P tile, in floats
constexpr float NEG_INF = -1e30f;

// A 16-byte chunk of the input, unpacked to float32.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
    static constexpr int N = 4;
    __device__ static void unpack(const uint4& r, float* o) {
        o[0] = __uint_as_float(r.x); o[1] = __uint_as_float(r.y);
        o[2] = __uint_as_float(r.z); o[3] = __uint_as_float(r.w);
    }
    __device__ static float store(float x) { return x; }
};
template <> struct Chunk<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ static void unpack(const uint4& r, float* o) {
        const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {   // little endian: low half first
            o[2 * i] = __uint_as_float(w[i] << 16);
            o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
    __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int c, bool valid,
                                           float* x) {
    if (valid) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row) + c);
        Chunk<T>::unpack(raw, x);
    } else {
#pragma unroll
        for (int e = 0; e < Chunk<T>::N; ++e) x[e] = 0.f;
    }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 4) {
            const float4 t = *reinterpret_cast<const float4*>(p + i);
            out[i] = t.x; out[i + 1] = t.y; out[i + 2] = t.z; out[i + 3] = t.w;
        }
    } else {
        static_assert(N == 2, "columns per thread");
        const float2 t = *reinterpret_cast<const float2*>(p);
        out[0] = t.x; out[1] = t.y;
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, HD > 128 ? 1 : 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int T_len,
                 int H, int Kv, int causal, int window, float scale) {
    constexpr int CN = Chunk<T>::N;   // elements per 16-byte chunk
    constexpr int CPR = HD / CN;      // chunks per row
    constexpr int CPT = HD / 16;      // output columns per thread
    extern __shared__ __align__(16) float smem[];
    float* Qt = smem;                 // [HD][BQ] queries, transposed
    float* KV = Qt + HD * BQ;         // [HD][BK] keys transposed, then [BK][HD] values
    float* P = KV + HD * BK;          // [BQ][PS] probabilities of the tile

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / Kv);
    const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)Kv * HD;
    const T* qb = q + ((size_t)b * S * H + h) * HD;
    const T* kb = k + ((size_t)b * T_len * Kv + kvh) * HD;
    const T* vb = v + ((size_t)b * T_len * Kv + kvh) * HD;

    // Neighbouring threads take neighbouring rows, so the transposed stores
    // fall in distinct banks.
    for (int i = tid; i < BQ * CPR; i += THREADS) {
        const int r = i % BQ, c = i / BQ;
        float x[CN];
        load_chunk(qb + (size_t)(q0 + r) * q_stride, c, q0 + r < S, x);
#pragma unroll
        for (int e = 0; e < CN; ++e) Qt[(c * CN + e) * BQ + r] = x[e];
    }

    float m[4], l[4], acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
    }

    const int q_last = min(q0 + BQ, S) - 1;
    int n_tiles = (T_len + BK - 1) / BK;
    if (causal) n_tiles = min(n_tiles, q_last / BK + 1);
    // the band of the block's first row starts at key q0 - window + 1; a
    // later row whose keys all lie past a tile starts with that tile fully
    // masked, which the next tile's rescale (alpha = 0) wipes out
    const int kt_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;

    for (int kt = kt_first; kt < n_tiles; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();              // the last tile's V and P are consumed
        for (int i = tid; i < BK * CPR; i += THREADS) {
            const int j = i % BK, c = i / BK;
            float x[CN];
            load_chunk(kb + (size_t)(k0 + j) * kv_stride, c, k0 + j < T_len, x);
#pragma unroll
            for (int e = 0; e < CN; ++e) KV[(c * CN + e) * BK + j] = x[e];
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            const float4 qa = *reinterpret_cast<const float4*>(Qt + d * BQ + 4 * ty);
            const float4 ka = *reinterpret_cast<const float4*>(KV + d * BK + 4 * tx);
            const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
            const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

        // Online softmax over the tile. The 16 threads of a row group are
        // one half of a warp; xor shuffles up to 8 stay inside it.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qp = q0 + 4 * ty + i;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kp = k0 + 4 * tx + j;
                const bool keep = kp < T_len && (!causal || kp <= qp) &&
                                  (window <= 0 || kp > qp - window);
                s[i][j] = keep ? s[i][j] * scale : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                sum += s[i][j];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = alpha * l[i] + sum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
            *reinterpret_cast<float4*>(P + (4 * ty + i) * PS + 4 * tx) =
                make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        }
        __syncthreads();              // K is consumed; P is complete

        for (int i = tid; i < BK * CPR; i += THREADS) {
            const int j = i / CPR, c = i % CPR;
            float x[CN];
            load_chunk(vb + (size_t)(k0 + j) * kv_stride, c, k0 + j < T_len, x);
#pragma unroll
            for (int e = 0; e < CN; e += 4)
                *reinterpret_cast<float4*>(KV + j * HD + c * CN + e) =
                    make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
        }
        __syncthreads();

#pragma unroll 2
        for (int j = 0; j < BK; j += 4) {
            float p[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 t = *reinterpret_cast<const float4*>(P + (4 * ty + i) * PS + j);
                p[i][0] = t.x; p[i][1] = t.y; p[i][2] = t.z; p[i][3] = t.w;
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                float vv[CPT];
                load_vec<CPT>(KV + (j + jj) * HD + tx * CPT, vv);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int c = 0; c < CPT; ++c)
                        acc[i][c] = fmaf(p[i][jj], vv[c], acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qp = q0 + 4 * ty + i;
        if (qp >= S) continue;
        const float denom = fmaxf(l[i], 1e-20f);
        T* dst = o + ((size_t)b * S + qp) * q_stride + (size_t)h * HD + tx * CPT;
#pragma unroll
        for (int c = 0; c < CPT; ++c) dst[c] = Chunk<T>::store(acc[i][c] / denom);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t S, int64_t T_len, int H, int Kv, int causal, int window,
           cudaStream_t stream) {
    const int smem = (int)sizeof(float) * (HD * BQ + HD * BK + BQ * PS);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned int)((S + BQ - 1) / BQ), (unsigned int)H,
                    (unsigned int)B);
    flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)S, (int)T_len, H, Kv,
        causal, window, 1.0f / sqrtf((float)HD));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int64_t B,
              int64_t S, int64_t T_len, int H, int Kv, int hd, int causal,
              int window, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<T, 32>(q, k, v, o, B, S, T_len, H, Kv, causal, window, stream);
        case 64: return launch<T, 64>(q, k, v, o, B, S, T_len, H, Kv, causal, window, stream);
        case 128: return launch<T, 128>(q, k, v, o, B, S, T_len, H, Kv, causal, window, stream);
        case 256: return launch<T, 256>(q, k, v, o, B, S, T_len, H, Kv, causal, window, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q: (B, S, H, hd); k, v: (B, T, Kv, hd); out: (B, S, H, hd); contiguous,
// one dtype: 0 = float32, 1 = bfloat16. hd in {32, 64, 128, 256};
// H % Kv == 0; window 0 for none. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int pnp_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, int64_t B,
                                       int64_t S, int64_t T, int32_t H,
                                       int32_t Kv, int32_t hd, int32_t causal,
                                       int32_t window, int32_t dtype,
                                       void* stream) {
    if (B < 0 || S < 0 || T < 1 || H < 1 || Kv < 1 || H % Kv || window < 0 ||
        S > INT32_MAX || T > INT32_MAX || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || S == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_hd<float>(q, k, v, out, B, S, T, H, Kv, hd, causal, window, st);
    if (dtype == 1)
        return launch_hd<__nv_bfloat16>(q, k, v, out, B, S, T, H, Kv, hd, causal,
                                        window, st);
    return (int)cudaErrorInvalidValue;
}
