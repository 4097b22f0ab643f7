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
// (2.2e10, 0.33 ms at 67 TFLOP/s float32): near the ridge, so both count.
// The steps of one (b, h) are sequential; its V columns are independent
// chains (column v of S evolves alone, o_t[v] sums over k only).
//
// What the design does about it:
// - the bonus term is one scalar a step: o_t = r_t^T S + a_t v_t with
//   a_t = sum_k r_tk u_k k_tk, computed once per (b, h, t) while a chunk is
//   converted, so a state value costs three FMA-pipe instructions a step
//   (k v, the FMA r s into the output, the FMA w s + k v);
// - a register tile of 16 rows x 4 columns a thread: one block of 64
//   threads holds a head's 64 x 64 state, thread (vq, kq) the rows
//   16 j + 4 kq + e (j, e < 4) of columns 4 vq .. 4 vq + 3. A step loads
//   r, k, w of its 16 rows (12 float4) and v of its 4 columns (16 bytes)
//   from shared memory: 0.2 16-byte loads a state value. Lane 8 kq + vq % 8
//   of warp vq / 8 holds tile (vq, kq), so each r, k, w load is shared by
//   a run of 8 neighbouring lanes: on an H100 such a broadcast costs the
//   shared pipe 2 cycles a warp, against 4 when the lanes that share an
//   address are not neighbours;
// - the four partial outputs of a column (one per kq) meet in a fixed
//   reduce-scatter of three shuffles a step, after which lane kq holds
//   column 4 vq + kq and a warp stores 32 consecutive outputs. Each lane
//   keeps its four columns in its own register order ("slots", below) so
//   that the partial sums it sends are finished first: the shuffles run
//   while the rest of the step's FMAs issue;
// - TCH = 16 steps are staged at once: cp.async copies chunk n + 1 into a
//   raw buffer (16-byte pieces, the model's dtype) while chunk n steps;
//   between chunks the block converts the raw buffer to float32 once per
//   value (and computes a_t), so it synchronises twice per 16 steps.
//   Shapes whose rows are not whole 16-byte pieces (or unaligned views)
//   are staged with plain loads instead;
// - 512 blocks of two warps at the serve shape: four blocks (eight warps)
//   an SM, one wave;
// - no atomics and a fixed order of every sum: two launches give the same
//   bits.
// Rows k >= K and columns v >= V are zero in the staged buffers and never
// stored, so one instantiation per dtype serves every K, V up to 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // rows and columns a block covers
constexpr int TK = 16;         // state rows a thread holds
constexpr int KQ = D / TK;     // threads sharing a column group (of 4)
constexpr int THREADS = KQ * D / 4;
constexpr int TCH = 16;        // steps staged per chunk
constexpr int G = D / 4;       // float4 groups in a staged row
constexpr int CP = THREADS / TCH;   // threads converting one staged row
constexpr int XQ = 8;          // lane distance between kq and kq ^ 1
static_assert(THREADS == 64 && G % CP == 0, "block shape");

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(x.x << 16),
                       __uint_as_float(x.x & 0xffff0000u),
                       __uint_as_float(x.y << 16),
                       __uint_as_float(x.y & 0xffff0000u));
}
__device__ __forceinline__ float part(const float4& q, int e) {
    return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

// Slot i of thread kq holds column kq ^ (3 - i) of its group of four:
// slots 0 and 1 are what it sends at the first shuffle (to kq ^ 2), slot 2
// what it sends at the second (to kq ^ 1), slot 3 its own column.
__device__ __forceinline__ float4 to_slots(const float4& c, int kq) {
    const bool b0 = kq & 1, b1 = kq & 2;
    const float own0 = b1 ? c.z : c.x, own1 = b1 ? c.w : c.y;
    const float oth0 = b1 ? c.x : c.z, oth1 = b1 ? c.y : c.w;
    return make_float4(b0 ? oth0 : oth1, b0 ? oth1 : oth0,
                       b0 ? own0 : own1, b0 ? own1 : own0);
}
__device__ __forceinline__ float4 from_slots(const float4& s, int kq) {
    const bool b0 = kq & 1, b1 = kq & 2;
    const float own0 = b0 ? s.z : s.w, own1 = b0 ? s.w : s.z;
    const float oth0 = b0 ? s.x : s.y, oth1 = b0 ? s.y : s.x;
    return b1 ? make_float4(oth0, oth1, own0, own1)
              : make_float4(own0, own1, oth0, oth1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies `n` rows of `bytes` each (a multiple of 16, at most 256), `stride`
// bytes apart in device memory, to rows of `row_bytes` in shared memory:
// thread tid takes piece tid % 16 of rows tid / 16, + 4, + 8, + 12.
__device__ __forceinline__ void copy_rows(void* dst, int row_bytes,
                                          const void* src, size_t stride,
                                          int bytes, int n, int tid) {
    const int p = tid & 15;
    if (p * 16 >= bytes) return;
#pragma unroll
    for (int i = 0; i < TCH / 4; ++i) {
        const int tt = (tid >> 4) + 4 * i;
        if (tt < n)
            cp_async16((char*)dst + tt * row_bytes + p * 16,
                       (const char*)src + tt * stride + p * 16);
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0, float* o,
            float* sT, int S, int H, int K, int V, bool async_copy,
            bool vec_state) {
    // raw: a chunk as it arrives (rows padded to D, pads zero); f*: the
    // same converted once, read by the steps; fa: a_t
    __shared__ __align__(16) T raw_r[TCH * D], raw_k[TCH * D], raw_v[TCH * D];
    __shared__ __align__(16) float raw_w[TCH * D];
    __shared__ float4 fr[TCH][G], fk[TCH][G], fw[TCH][G], fv[TCH][G];
    __shared__ float fa[TCH];

    const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
    // stepping: tile (vq, kq), lane 8 kq + vq % 8 of warp vq / 8, so that
    // runs of 8 lanes load the same r, k, w (a broadcast shared load costs
    // half as much when the lanes that share an address are neighbours)
    const int kq = (tid >> 3) & 3, vq = (tid >> 5) * 8 + (tid & 7);
    const int ct = tid / CP, cq = tid % CP;    // converting: row ct, part cq
    const int col0 = 4 * vq;
    const size_t state0 = ((size_t)b * H + h) * K * V;
    const size_t row_rk = (size_t)H * K, row_v = (size_t)H * V;

    // zero the raw buffers once: rows past K (V) stay zero for the run
    {
        constexpr int RW = TCH * D * sizeof(T) / 16;
        uint4* zr = reinterpret_cast<uint4*>(raw_r);
        uint4* zk = reinterpret_cast<uint4*>(raw_k);
        uint4* zv = reinterpret_cast<uint4*>(raw_v);
        uint4* zw = reinterpret_cast<uint4*>(raw_w);
        const uint4 z = make_uint4(0, 0, 0, 0);
        for (int i = tid; i < RW; i += THREADS) zr[i] = zk[i] = zv[i] = z;
        for (int i = tid; i < TCH * D / 4; i += THREADS) zw[i] = z;
    }

    // u of the rows this thread converts: groups cq + CP j
    float4 uc[G / CP];
#pragma unroll
    for (int j = 0; j < G / CP; ++j) {
        float e[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int kk = 4 * (cq + CP * j) + x;
            e[x] = kk < K ? u[(size_t)h * K + kk] : 0.f;
        }
        uc[j] = make_float4(e[0], e[1], e[2], e[3]);
    }

    // the state tile: s[4 j + e] is row 16 j + 4 kq + e (float4 group
    // 4 j + kq of a staged row), its four columns in slot order
    float4 s[TK];
#pragma unroll
    for (int i = 0; i < TK; ++i) {
        const int kk = 16 * (i >> 2) + 4 * kq + (i & 3);
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s0 && kk < K) {
            const float* src = s0 + state0 + (size_t)kk * V + col0;
            if (vec_state && col0 < V) {
                x = load4(src);
            } else {
                if (col0 < V) x.x = src[0];
                if (col0 + 1 < V) x.y = src[1];
                if (col0 + 2 < V) x.z = src[2];
                if (col0 + 3 < V) x.w = src[3];
            }
        }
        s[i] = to_slots(x, kq);
    }
    __syncthreads();

    auto stage = [&](int t0) {
        const int n = min(TCH, S - t0);
        const size_t row0 = ((size_t)b * S + t0) * H + h;
        if (async_copy) {
            copy_rows(raw_r, D * sizeof(T), r + row0 * K,
                      row_rk * sizeof(T), K * sizeof(T), n, tid);
            copy_rows(raw_k, D * sizeof(T), k + row0 * K,
                      row_rk * sizeof(T), K * sizeof(T), n, tid);
            copy_rows(raw_v, D * sizeof(T), v + row0 * V,
                      row_v * sizeof(T), V * sizeof(T), n, tid);
            copy_rows(raw_w, D * 4, w + row0 * K, row_rk * 4, K * 4, n, tid);
        } else {
            for (int tt = 0; tt < n; ++tt) {
                const size_t at = row0 + (size_t)tt * H;
                if (tid < K) {
                    raw_r[tt * D + tid] = r[at * K + tid];
                    raw_k[tt * D + tid] = k[at * K + tid];
                    raw_w[tt * D + tid] = w[at * K + tid];
                }
                if (tid < V) raw_v[tt * D + tid] = v[at * V + tid];
            }
        }
    };

    const int chunks = (S + TCH - 1) / TCH;
    if (chunks > 0) stage(0);
    for (int c = 0; c < chunks; ++c) {
        const int t0 = c * TCH, n = min(TCH, S - t0);
        cp_async_wait_all();
        __syncthreads();   // chunk c arrived; the steps of c - 1 are done

        // convert chunk c to float32 and compute a_t = sum_k r u k: thread
        // (ct, cq) takes groups cq + CP j of row ct, CP threads a row
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < G / CP; ++j) {
            const int g = cq + CP * j, at = ct * D + 4 * g;
            const float4 rr = load4(raw_r + at), kk = load4(raw_k + at);
            fr[ct][g] = rr;
            fk[ct][g] = kk;
            fw[ct][g] = load4(raw_w + at);
            fv[ct][g] = load4(raw_v + at);
            a = fmaf(rr.x, uc[j].x * kk.x, a);
            a = fmaf(rr.y, uc[j].y * kk.y, a);
            a = fmaf(rr.z, uc[j].z * kk.z, a);
            a = fmaf(rr.w, uc[j].w * kk.w, a);
        }
#pragma unroll
        for (int m = 1; m < CP; m *= 2)
            a += __shfl_xor_sync(0xffffffffu, a, m);
        if (cq == 0) fa[ct] = a;
        __syncthreads();   // chunk c converted; the raw buffer is free

        if (c + 1 < chunks) stage(t0 + TCH);   // lands while chunk c steps

        float* out = o + (((size_t)b * S + t0) * H + h) * V + col0 + kq;
        const bool store = col0 + kq < V;
#pragma unroll 1
        for (int tt = 0; tt < n; ++tt) {
            const float4 vs = to_slots(fv[tt][vq], kq);
            float4 rr[TK / 4], kk[TK / 4], ww[TK / 4];
#pragma unroll
            for (int j = 0; j < TK / 4; ++j) {
                rr[j] = fr[tt][4 * j + kq];
                kk[j] = fk[tt][4 * j + kq];
                ww[j] = fw[tt][4 * j + kq];
            }
            // slots 0 and 1: partial outputs, then the state's updates
            float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
            for (int i = 0; i < TK; ++i) {
                const float ri = part(rr[i >> 2], i & 3),
                            ki = part(kk[i >> 2], i & 3),
                            wi = part(ww[i >> 2], i & 3);
                a0 = fmaf(ri, s[i].x, a0);
                a1 = fmaf(ri, s[i].y, a1);
                s[i].x = fmaf(wi, s[i].x, ki * vs.x);
                s[i].y = fmaf(wi, s[i].y, ki * vs.y);
            }
            // the partner kq ^ 2 owns the columns of slots 0 and 1; it
            // sends the partials of this lane's slots 2 and 3
            const float got2 = __shfl_xor_sync(0xffffffffu, a0, 2 * XQ),
                        got3 = __shfl_xor_sync(0xffffffffu, a1, 2 * XQ);
#pragma unroll
            for (int i = 0; i < TK; ++i) {
                const float ri = part(rr[i >> 2], i & 3),
                            ki = part(kk[i >> 2], i & 3),
                            wi = part(ww[i >> 2], i & 3);
                a2 = fmaf(ri, s[i].z, a2);
                s[i].z = fmaf(wi, s[i].z, ki * vs.z);
            }
            // slot 2's column, summed over the pair, goes to the partner
            // kq ^ 1, whose own column it is; this lane gets its own back
            const float got = __shfl_xor_sync(0xffffffffu, a2 + got2, XQ);
#pragma unroll
            for (int i = 0; i < TK; ++i) {
                const float ri = part(rr[i >> 2], i & 3),
                            ki = part(kk[i >> 2], i & 3),
                            wi = part(ww[i >> 2], i & 3);
                a3 = fmaf(ri, s[i].w, a3);
                s[i].w = fmaf(wi, s[i].w, ki * vs.w);
            }
            if (store)
                out[(size_t)tt * row_v] =
                    fmaf(fa[tt], vs.w, (a3 + got3) + got);
        }
    }

#pragma unroll
    for (int i = 0; i < TK; ++i) {
        const int kk = 16 * (i >> 2) + 4 * kq + (i & 3);
        if (kk >= K) continue;
        float* dst = sT + state0 + (size_t)kk * V + col0;
        const float4 x = from_slots(s[i], kq);
        if (vec_state && col0 < V) {
            *reinterpret_cast<float4*>(dst) = x;
        } else {
            if (col0 < V) dst[0] = x.x;
            if (col0 + 1 < V) dst[1] = x.y;
            if (col0 + 2 < V) dst[2] = x.z;
            if (col0 + 3 < V) dst[3] = x.w;
        }
    }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* o, float* sT, int64_t B,
           int64_t S, int H, int K, int V, cudaStream_t stream) {
    const int es = (int)sizeof(T);
    const bool async_copy = (K * es) % 16 == 0 && (V * es) % 16 == 0 &&
                            aligned16(r) && aligned16(k) && aligned16(v) &&
                            aligned16(w);
    const bool vec_state = V % 4 == 0 && (!s0 || aligned16(s0)) &&
                           aligned16(sT);
    const dim3 grid((unsigned int)H, (unsigned int)B);
    wkv6_kernel<T><<<grid, THREADS, 0, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, w, u, s0, o, sT, (int)S, H, K,
        V, async_copy, vec_state);
    return (int)cudaGetLastError();
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
    if (B < 0 || S < 0 || H < 1 || K < 1 || K > D || V < 1 || V > D ||
        S > INT32_MAX || B > 65535)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const float *wf = (const float*)w, *uf = (const float*)u,
                *sf = (const float*)s0;
    float *of = (float*)out, *tf = (float*)s_final;
    if (dtype == 0)
        return launch<float>(r, k, v, wf, uf, sf, of, tf, B, S, H, K, V, st);
    if (dtype == 1)
        return launch<__nv_bfloat16>(r, k, v, wf, uf, sf, of, tf, B, S, H, K,
                                     V, st);
    return (int)cudaErrorInvalidValue;
}
