// Backward of the RWKV-6 WKV recurrence (wkv6.cu), one launch for a whole
// sequence, plus a small launch that sums the bonus's gradient over the
// batch.
//
// Replaces no TPU kernel on its own: the reference has no Pallas backward
// (jax.grad differentiates the `lax.scan` of repro.models.rwkv6.wkv_ref, the
// function of src/repro/kernels/wkv6.py `_wkv6_kernel`). The port's training
// step reaches it through kernels/wkv6.py's autograd Function, once an RWKV
// layer and step.
//
// Per (b, h), with the K x V float32 state S_t after step t (S_{-1} = s0)
// and dS_t the gradient of S_t (dS_{S-1} = ds_final, zeros if null):
//   dr_t  = S_{t-1} do_t + u*k_t (v_t . do_t)
//   dk_t  = dS_t v_t + u*r_t (v_t . do_t)
//   dv_t  = dS_t^T k_t + (sum_k r_t u k_t) do_t
//   dw_t  = rowsum(dS_t * S_{t-1})
//   du   += r_t*k_t (v_t . do_t)
//   dS_{t-1} = diag(w_t) dS_t + r_t do_t^T
// Inputs as the forward's: r, k (B, S, H, K) and v (B, S, H, V) in one dtype
// (float32 or bfloat16), w (B, S, H, K) float32, u (H, K) float32, s0 (B, H,
// K, V) float32 or null; do (B, S, H, V) float32 (the forward's output is
// float32), ds_final (B, H, K, V) float32 or null. Out: dr, dk, dv in the
// inputs' dtype, dw float32, du (H, K) float32. K <= 64 and V <= 64.
//
// What bounds it on an H100: at the training call (B 32, S 256, H 64, K = V
// = 64, r, k, v bf16) it needs 12 float32 flops per (k, v) and step (the
// state recomputed, dr, dk, dv, dw and dS's update, two each): 2.6e10,
// 0.38 ms at 67 TFLOP/s, against 0.81 GB of r, k, v, w, do read and dr,
// dk, dv, dw written once (0.24 ms at 3.35 TB/s): the operations.
//
// The design, a simple one that is right (a later change makes it fast):
// one block of 256 threads a (b, h); thread (k = tid / 4, q = tid % 4) owns
// row k, columns 16 q .. 16 q + 15 of S and of dS, in registers.
// - pass 1 walks the steps forward, recomputing S, and writes it to a
//   workspace every L = 8 steps (the checkpoint before each chunk);
// - pass 2 walks the chunks from the last to the first: a chunk's r, k, w,
//   v and do are staged in shared memory as float32 (and the two scalars a
//   step needs, v.do and sum_k r u k, by one warp a step); its L states
//   S_{t-1} are recomputed from the checkpoint into shared memory (each
//   thread its own entries, so no barrier); then its steps run in reverse:
//   dr, dw and dk are sums over a row's 16-column pieces (two shuffles in a
//   fixed tree), dv a sum over k: three shuffles over a warp's 8 rows, then
//   the 8 warps' partials from shared memory in warp order;
// - du's per-(b, h) sum runs in the loop's (reverse time) order into a
//   (B, H, K) workspace, which the second kernel sums over b in order.
// No atomics and a fixed order of every sum: two launches give the same
// bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;            // K and V a block holds
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VE = 16;           // columns of S a thread holds
constexpr int L = 8;             // steps a chunk: the checkpoints' spacing
static_assert(L == WARPS, "one warp computes a step's two scalars");
static_assert(D * (D / VE) == THREADS, "a thread a (row, piece)");

// shared memory, in floats
constexpr int SBUF = L * VE * THREADS;   // the chunk's states, [L][VE][THREADS]
constexpr int VEC = L * D;               // a chunk's vectors, [L][D]
constexpr int SMEM_FLOATS = SBUF + 5 * VEC + 2 * L + 2 * WARPS * D + D;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Steps [t0, t0 + n) of (b, h) into the shared vectors; entries past n, K
// or V are zero. With `all`, r and do as well (pass 2).
template <typename T>
__device__ __forceinline__ void stage(float* rs, float* ks, float* ws, float* vs, float* gs,
                                      const T* __restrict__ r, const T* __restrict__ k,
                                      const T* __restrict__ v, const float* __restrict__ w,
                                      const float* __restrict__ dout, int b, int h, int t0,
                                      int n, int S, int H, int K, int V, bool all) {
    for (int i = threadIdx.x; i < L * D; i += THREADS) {
        const int j = i / D, e = i % D;
        const bool step = j < n;
        const size_t row = ((size_t)b * S + t0 + j) * H + h;
        const bool kin = step && e < K, vin = step && e < V;
        ks[i] = kin ? to_f(k[row * K + e]) : 0.f;
        ws[i] = kin ? w[row * K + e] : 0.f;
        vs[i] = vin ? to_f(v[row * V + e]) : 0.f;
        if (all) {
            rs[i] = kin ? to_f(r[row * K + e]) : 0.f;
            gs[i] = vin ? dout[row * V + e] : 0.f;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s0, const float* __restrict__ dout,
                const float* __restrict__ ds_final, T* __restrict__ dr, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ckpt, int S, int H, int K, int V) {
    extern __shared__ __align__(16) float smem[];
    float* sbuf = smem;                  // [L][VE][THREADS]
    float* rs = sbuf + SBUF;             // [L][D] each
    float* ks = rs + VEC;
    float* ws = ks + VEC;
    float* vs = ws + VEC;
    float* gs = vs + VEC;
    float* pq = gs + VEC;                // [L][2]: v.do, sum_k r u k
    float* red = pq + 2 * L;             // [2][WARPS][D]
    float* us = red + 2 * WARPS * D;     // [D]

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int row = tid / 4, q = tid % 4, c0 = q * VE;
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int n_chunks = (S + L - 1) / L;
    const size_t state_at = (size_t)bh * K * V;
    float* my_ckpt = ckpt + (size_t)bh * n_chunks * VE * THREADS + tid;
    if (tid < D) us[tid] = tid < K ? u[(size_t)h * K + tid] : 0.f;

    float st[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
        const bool in = s0 && row < K && c0 + e < V;
        st[e] = in ? s0[state_at + (size_t)row * V + c0 + e] : 0.f;
    }

    // pass 1: the state before each chunk, recomputed forward
    for (int c = 0; c < n_chunks; ++c) {
        const int t0 = c * L, n = min(L, S - t0);
#pragma unroll
        for (int e = 0; e < VE; ++e) my_ckpt[((size_t)c * VE + e) * THREADS] = st[e];
        __syncthreads();   // the last chunk is done with the vectors
        stage(rs, ks, ws, vs, gs, r, k, v, w, dout, b, h, t0, n, S, H, K, V, false);
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            const float wk = ws[j * D + row], kk = ks[j * D + row];
#pragma unroll
            for (int e = 0; e < VE; ++e) st[e] = fmaf(wk, st[e], kk * vs[j * D + c0 + e]);
        }
    }

    // pass 2: the chunks in reverse
    float ds[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
        const bool in = ds_final && row < K && c0 + e < V;
        ds[e] = in ? ds_final[state_at + (size_t)row * V + c0 + e] : 0.f;
    }
    float du_acc = 0.f;
    int buf = 0;
    for (int c = n_chunks - 1; c >= 0; --c) {
        const int t0 = c * L, n = min(L, S - t0);
        __syncthreads();   // the last chunk is done with the vectors
        stage(rs, ks, ws, vs, gs, r, k, v, w, dout, b, h, t0, n, S, H, K, V, true);
        __syncthreads();
        {   // warp j: step j's v.do and sum_k r u k, in a fixed tree
            const int j = warp;
            float p = vs[j * D + lane] * gs[j * D + lane] +
                      vs[j * D + lane + 32] * gs[j * D + lane + 32];
            float a = rs[j * D + lane] * us[lane] * ks[j * D + lane] +
                      rs[j * D + lane + 32] * us[lane + 32] * ks[j * D + lane + 32];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                p += __shfl_xor_sync(0xffffffffu, p, off);
                a += __shfl_xor_sync(0xffffffffu, a, off);
            }
            if (lane == 0) {
                pq[2 * j] = p;
                pq[2 * j + 1] = a;
            }
        }
        // the chunk's states S_{t-1}, each thread its own entries
#pragma unroll
        for (int e = 0; e < VE; ++e) st[e] = my_ckpt[((size_t)c * VE + e) * THREADS];
        for (int j = 0; j < n; ++j) {
            const float wk = ws[j * D + row], kk = ks[j * D + row];
#pragma unroll
            for (int e = 0; e < VE; ++e) {
                sbuf[(j * VE + e) * THREADS + tid] = st[e];
                st[e] = fmaf(wk, st[e], kk * vs[j * D + c0 + e]);
            }
        }
        __syncthreads();   // pq
        for (int j = n - 1; j >= 0; --j) {
            const int t = t0 + j;
            const float rk = rs[j * D + row], kk = ks[j * D + row], wk = ws[j * D + row];
            const float uk = us[row], p = pq[2 * j], a = pq[2 * j + 1];
            float dr_p = 0.f, dw_p = 0.f, dk_p = 0.f, x[VE], g[VE];
#pragma unroll
            for (int e = 0; e < VE; ++e) {
                const float sp = sbuf[(j * VE + e) * THREADS + tid];
                g[e] = gs[j * D + c0 + e];
                dr_p = fmaf(sp, g[e], dr_p);
                dw_p = fmaf(ds[e], sp, dw_p);
                dk_p = fmaf(ds[e], vs[j * D + c0 + e], dk_p);
                x[e] = ds[e] * kk;
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                dr_p += __shfl_xor_sync(0xffffffffu, dr_p, off);
                dw_p += __shfl_xor_sync(0xffffffffu, dw_p, off);
                dk_p += __shfl_xor_sync(0xffffffffu, dk_p, off);
            }
#pragma unroll
            for (int e = 0; e < VE; ++e)
#pragma unroll
                for (int off = 4; off < 32; off <<= 1)
                    x[e] += __shfl_xor_sync(0xffffffffu, x[e], off);
            float* red_b = red + buf * WARPS * D;
            if (lane < 4) {
#pragma unroll
                for (int e = 0; e < VE; ++e) red_b[warp * D + c0 + e] = x[e];
            }
            if (q == 0 && row < K) {
                const size_t at = ((size_t)b * S + t) * H + h;
                const float uk_kk = uk * kk;
                store(dr + at * K + row, fmaf(uk_kk, p, dr_p));
                store(dk + at * K + row, fmaf(uk * rk, p, dk_p));
                dw[at * K + row] = dw_p;
                du_acc = fmaf(rk * kk, p, du_acc);
            }
#pragma unroll
            for (int e = 0; e < VE; ++e) ds[e] = fmaf(wk, ds[e], rk * g[e]);
            __syncthreads();   // red_b
            if (tid < V) {
                float s = 0.f;
#pragma unroll
                for (int wi = 0; wi < WARPS; ++wi) s += red_b[wi * D + tid];
                const size_t at = ((size_t)b * S + t) * H + h;
                store(dv + at * V + tid, fmaf(a, gs[j * D + tid], s));
            }
            buf ^= 1;
        }
    }
    if (q == 0 && row < K) du_part[(size_t)bh * K + row] = du_acc;
}

// du (H, K) = the sum over b, in order, of du_part (B, H, K).
__global__ void wkv6_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                               int B, int HK) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= HK) return;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += du_part[(size_t)b * HK + i];
    du[i] = s;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, const float* dout, const float* ds_final, void* dr, void* dk,
           void* dv, float* dw, float* du, float* du_part, float* ckpt, int64_t B,
           int64_t S, int H, int K, int V, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (S > 0) {
        wkv6_bwd_kernel<T><<<(unsigned int)(B * H), THREADS, SMEM_BYTES, stream>>>(
            (const T*)r, (const T*)k, (const T*)v, w, u, s0, dout, ds_final, (T*)dr,
            (T*)dk, (T*)dv, dw, du_part, ckpt, (int)S, H, K, V);
    } else {
        cudaMemsetAsync(du_part, 0, (size_t)B * H * K * 4, stream);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int HK = H * K;
    wkv6_du_kernel<<<(HK + 255) / 256, 256, 0, stream>>>(du_part, du, (int)B, HK);
    return (int)cudaGetLastError();
}

}  // namespace

// Words (float32) of the workspace a call needs: the checkpoints, then
// du_part.
extern "C" int64_t pnp_wkv6_bwd_workspace_words(int64_t B, int64_t S, int32_t H,
                                                int32_t K) {
    const int64_t n_chunks = (S + L - 1) / L;
    return B * H * (n_chunks * VE * THREADS + K);
}

// Shared bytes a block and the registers and local bytes the runtime
// reports for each dtype's instance: 5 ints (shared, f32 regs, f32 local,
// bf16 regs, bf16 local).
extern "C" int pnp_wkv6_bwd_info(int32_t* out) {
    cudaFuncAttributes attr;
    out[0] = SMEM_BYTES;
    cudaError_t err = cudaFuncGetAttributes(&attr, wkv6_bwd_kernel<float>);
    if (err != cudaSuccess) return (int)err;
    out[1] = attr.numRegs;
    out[2] = (int32_t)attr.localSizeBytes;
    err = cudaFuncGetAttributes(&attr, wkv6_bwd_kernel<__nv_bfloat16>);
    if (err != cudaSuccess) return (int)err;
    out[3] = attr.numRegs;
    out[4] = (int32_t)attr.localSizeBytes;
    return 0;
}

// See the top of the file for the arguments; s0 and ds_final may be null;
// ws holds pnp_wkv6_bwd_workspace_words(B, S, H, K) floats. dtype 0: r, k,
// v, dr, dk, dv float32; 1: bfloat16. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int pnp_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* s0, const void* dout,
                            const void* ds_final, void* dr, void* dk, void* dv, void* dw,
                            void* du, void* ws, int64_t B, int64_t S, int32_t H,
                            int32_t K, int32_t V, int32_t dtype, void* stream) {
    if (B < 0 || S < 0 || H < 1 || K < 1 || K > D || V < 1 || V > D || S > INT32_MAX ||
        B * H > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (B == 0) return (int)cudaMemsetAsync(du, 0, (size_t)H * K * 4, st);
    const int64_t n_chunks = (S + L - 1) / L;
    float* ckpt = (float*)ws;
    float* du_part = ckpt + B * H * n_chunks * VE * THREADS;
#define PNP_WKV6_BWD_ARGS r, k, v, (const float*)w, (const float*)u, (const float*)s0, \
        (const float*)dout, (const float*)ds_final, dr, dk, dv, (float*)dw, (float*)du,  \
        du_part, ckpt, B, S, H, K, V, st
    if (dtype == 0) return launch<float>(PNP_WKV6_BWD_ARGS);
    if (dtype == 1) return launch<__nv_bfloat16>(PNP_WKV6_BWD_ARGS);
#undef PNP_WKV6_BWD_ARGS
    return (int)cudaErrorInvalidValue;
}
