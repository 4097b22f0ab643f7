// RWKV-6 WKV recurrence, one launch for a whole sequence.
//
// Replaces: src/repro/kernels/wkv6.py `_wkv6_kernel` / `wkv6_pallas`
// (reached through `ops.wkv6`), whose function is
// `repro.models.rwkv6.wkv_ref`: every RWKV-6 layer computes it, in prefill
// and at every decode step. Per (b, h), with a K x V float32 state S:
//     o_t = r_t^T (S + (u * k_t) v_t^T)
//     S   <- diag(w_t) S + k_t v_t^T
//
// Inputs are read in place in the model's layout, with no fold or
// transpose copy: r, k (B, S, H, K) and v (B, S, H, V) in one dtype
// (float32 or bfloat16, as the time mix makes them), w (B, S, H, K)
// float32, u (H, K) float32, s0 (B, H, K, V) float32 or null (zeros); all
// contiguous. Out: o (B, S, H, V) and s_final (B, H, K, V), float32.
// K <= 64 and V <= 64.
//
// What bounds it on an H100: at the serve shape (B 8, S 2048, H 64,
// K = V = 64, r, k, v bf16) it moves 0.96 GB (r, k, v, w, o once each;
// 0.29 ms at 3.35 TB/s) and the function needs 5 flops per (k, v) and step
// (k v, then an FMA each for the state and the output; 2.2e10, 0.33 ms at
// 67 TFLOP/s float32): near the ridge, so both count. The steps of one
// (b, h) are sequential, and there are only B x H = 512 of them.
//
// What the design does about it:
// - one block per (h, b) with 4 threads per value column: thread (v, kq)
//   holds the K/4 state rows k = 4 i + kq of column v in registers, so the
//   state never leaves the chip and 512 blocks give 131,072 threads;
// - TCH = 16 steps of r, k, w are staged at once in shared memory as one
//   float4 {r, k, w, 0} per (t, k) (one 16-byte load per row and step; the
//   four kq lanes read neighbouring float4s, broadcast across v), v beside
//   them; the block synchronises twice per 16 steps, not per step;
// - a step costs each thread K/4 x (a multiply and three FMAs: the bonus
//   u k v is folded into the state's column, 7 flops where 5 would do), two
//   xor shuffles sum the four partial outputs of a column in a fixed
//   order; outputs are staged per chunk and written with coalesced stores;
// - no atomics and a fixed order: the output is the same from run to run.
// Rows k >= K and columns v >= V are zero-padded and never stored, so one
// instantiation serves every K up to 4 x KPT.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KSPLIT = 4;   // threads per value column
constexpr int TCH = 16;     // steps staged per chunk
constexpr int VMAX = 64;    // value columns a block holds

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// KPT: state rows per thread (K <= 4 KPT).
template <typename T, int KPT>
__global__ void __launch_bounds__(KSPLIT * VMAX)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0, float* o,
            float* sT, int S, int H, int K, int V) {
    constexpr int KMAX = KSPLIT * KPT;
    __shared__ float4 rkw[TCH][KMAX];
    __shared__ float vs[TCH][VMAX];
    __shared__ float os[TCH][VMAX];

    const int tid = threadIdx.x, kq = tid % KSPLIT, vi = tid / KSPLIT;
    const int h = blockIdx.x, b = blockIdx.y;
    const bool col = vi < V;
    const size_t state0 = ((size_t)b * H + h) * K * V;

    float s[KPT], uk[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
        const int kk = i * KSPLIT + kq;
        const bool row = kk < K;
        s[i] = (row && col && s0) ? s0[state0 + (size_t)kk * V + vi] : 0.f;
        uk[i] = row ? u[(size_t)h * K + kk] : 0.f;
    }

    for (int t0 = 0; t0 < S; t0 += TCH) {
        const int n = min(TCH, S - t0);
        for (int idx = tid; idx < TCH * KMAX; idx += blockDim.x) {
            const int tt = idx / KMAX, kk = idx % KMAX;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (tt < n && kk < K) {
                const size_t at = (((size_t)b * S + t0 + tt) * H + h) * K + kk;
                x.x = to_f(r[at]);
                x.y = to_f(k[at]);
                x.z = w[at];
            }
            rkw[tt][kk] = x;
        }
        for (int idx = tid; idx < TCH * VMAX; idx += blockDim.x) {
            const int tt = idx / VMAX, vv = idx % VMAX;
            vs[tt][vv] = (tt < n && vv < V)
                ? to_f(v[(((size_t)b * S + t0 + tt) * H + h) * V + vv]) : 0.f;
        }
        __syncthreads();

        for (int tt = 0; tt < n; ++tt) {
            const float vv = vs[tt][vi];
            float out = 0.f;
#pragma unroll
            for (int i = 0; i < KPT; ++i) {
                const float4 x = rkw[tt][i * KSPLIT + kq];
                const float kv = x.y * vv;
                out = fmaf(x.x, fmaf(uk[i], kv, s[i]), out);
                s[i] = fmaf(x.z, s[i], kv);
            }
            out += __shfl_xor_sync(0xffffffffu, out, 1);
            out += __shfl_xor_sync(0xffffffffu, out, 2);
            if (kq == 0) os[tt][vi] = out;
        }
        __syncthreads();

        for (int idx = tid; idx < n * V; idx += blockDim.x) {
            const int tt = idx / V, vv = idx % V;
            o[(((size_t)b * S + t0 + tt) * H + h) * V + vv] = os[tt][vv];
        }
    }

#pragma unroll
    for (int i = 0; i < KPT; ++i) {
        const int kk = i * KSPLIT + kq;
        if (kk < K && col) sT[state0 + (size_t)kk * V + vi] = s[i];
    }
}

template <typename T, int KPT>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* o, float* sT, int64_t B,
           int64_t S, int H, int K, int V, cudaStream_t stream) {
    const int threads = ((KSPLIT * V + 31) / 32) * 32;
    const dim3 grid((unsigned int)H, (unsigned int)B);
    wkv6_kernel<T, KPT><<<grid, threads, 0, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, w, u, s0, o, sT, (int)S, H, K, V);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* o, float* sT, int64_t B,
             int64_t S, int H, int K, int V, cudaStream_t st) {
    if (K <= 4) return launch<T, 1>(r, k, v, w, u, s0, o, sT, B, S, H, K, V, st);
    if (K <= 8) return launch<T, 2>(r, k, v, w, u, s0, o, sT, B, S, H, K, V, st);
    if (K <= 16) return launch<T, 4>(r, k, v, w, u, s0, o, sT, B, S, H, K, V, st);
    if (K <= 32) return launch<T, 8>(r, k, v, w, u, s0, o, sT, B, S, H, K, V, st);
    return launch<T, 16>(r, k, v, w, u, s0, o, sT, B, S, H, K, V, st);
}

}  // namespace

// See the top of the file for the layouts. dtype of r, k, v: 0 = float32,
// 1 = bfloat16. s0 may be null (a zero state). K and V in
// [1, 64]. Launches on `stream` and returns cudaGetLastError().
extern "C" int pnp_wkv6(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* out, void* s_final, int64_t B, int64_t S,
                        int32_t H, int32_t K, int32_t V, int32_t dtype,
                        void* stream) {
    if (B < 0 || S < 0 || H < 1 || K < 1 || K > 64 || V < 1 || V > VMAX ||
        S > INT32_MAX || B > 65535)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const float *wf = (const float*)w, *uf = (const float*)u,
                *sf = (const float*)s0;
    float *of = (float*)out, *tf = (float*)s_final;
    if (dtype == 0)
        return launch_k<float>(r, k, v, wf, uf, sf, of, tf, B, S, H, K, V, st);
    if (dtype == 1)
        return launch_k<__nv_bfloat16>(r, k, v, wf, uf, sf, of, tf, B, S, H, K, V, st);
    return (int)cudaErrorInvalidValue;
}
