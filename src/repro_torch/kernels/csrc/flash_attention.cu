// Attention forward with an online softmax (flash attention) on the CUDA
// cores, in float32 FMAs.
//
// Replaces: src/repro/kernels/flash_attention.py `_flash_kernel` /
// `flash_attention_pallas` (reached through `ops.flash_attention`), whose
// function is `repro.models.attention.chunked_attention`'s: every prefill
// layer of a dense model computes it. kernels/flash_attention.py sends
// float32 (and head dims 16 and 32) here; bf16 at head dims 64-256 goes to the
// tensor-core kernel, flash_attention_tc.cu.
//
// q (B, S, H, hd), k and v (B, T, Kv, hd), out (B, S, H, hd), all in one
// dtype (float32 or bfloat16), contiguous. float32 math inside: scores
// scaled by 1/sqrt(hd), masked scores -1e30, out = acc / max(l, 1e-20).
// With `causal`, query s sees keys t <= s (queries at offset 0); with
// `window` > 0 only keys t > s - window (recurrentgemma's local attention).
//
// What bounds it on an H100: operations. At qwen3-0.6b's prefill shape
// (S = T = 2048, hd 128) it does 4 hd flops per (query, key) pair against
// 2 hd x 4 bytes of q and out per query; in float32, with no tensor cores
// (no TF32: that would change the numbers), the peak is 67 TFLOP/s of FMAs
// on the CUDA cores. Feeding them is the hard part: an SM's shared memory
// hands its lanes ~128 bytes a cycle (a 16-byte load of a warp takes 4
// cycles, 2 when the 8 lanes of each quarter-warp read one address:
// chip_probes.py's shared_loads), against 128 FMAs a cycle. So each float
// a lane loads from shared memory must feed ~4 FMAs, and every issue slot
// that is not an FFMA is lost. The design:
// - a block owns BQ = 2 TM x WARPS query rows of one (batch row, head); a
//   warp owns 2 TM of them, so a row's softmax (max, sum, rescale) and its
//   P row stay inside the warp (shuffles, no block barrier). Blocks are
//   issued heaviest (last) causal tile first;
// - register micro-tiles: lane (ty, tx) = (lane / 16, lane % 16) owns TM =
//   8 rows (4 at hd 256) by BK / 16 keys of a score tile, and the same rows
//   by hd / 16 columns of the output. The 8 lanes of a quarter-warp share
//   their rows, so a 16-byte load of Q or P is one broadcast (2 cycles) that
//   feeds 4 BK / 16 or 4 hd / 16 FMAs, and a load of K or V (4 cycles) feeds
//   4 TM. At hd 128 and BK 64 the shared loads take ~7/8 of the FMAs' time;
//   rows are padded by 4 floats (P rows by 16), so no load or store of Q, K,
//   V or P has a bank conflict. P goes through shared memory 32 keys at a
//   time (each warp its own rows, so `__syncwarp` orders it), which keeps a
//   block at 111 KB at hd 128 and BK 64: two blocks share an SM, and their
//   warps' score and PV phases interleave;
// - K and V go through shared memory in tiles of BK keys, in separate rings
//   of STAGES buffers each, copied by cp.async (16-byte pieces, zero-filled
//   past T) ahead of their use: tile t + 1's K is in flight while tile t's
//   softmax and PV run, and its V while tile t + 1's scores run. Two
//   barriers a tile, one before each product;
// - scores are scaled by 1/sqrt(hd) * log2(e) in the one multiply they
//   need anyway, and the softmax runs in base 2 (exp2f), one exponential a
//   score; the mask is applied only on tiles that cross the diagonal, the
//   window's edge or the end of T;
// - GQA and MQA by index: query head h reads KV head h / (H / Kv), with no
//   repeated copy of K and V;
// - causal blocks stop at the diagonal tile and never load the tiles above
//   it; windowed blocks start at the first tile that holds a key inside the
//   band of their first row;
// - one block owns each output row and reduces its keys in a fixed order
//   (fixed shuffle trees, no atomics), so the output is the same bits from
//   launch to launch.
// The instance with LSE = true (float32 at hd 16, 32, 64 and 128, the training
// forward) also writes each row's log-sum-exp of its scaled scores, float32
// (B, H, S) in natural-log units, for the backward (flash_attention_bwd.cu);
// the serving instances (LSE = false) compile without that store.
// bfloat16 inputs are staged through registers (converted to float32 on
// the way into shared memory) at the same points of the pipeline.
// WARPS, BK and STAGES for hd <= 128 are the fastest in chip_probes.py's
// flash_tiles sweep, which builds this file at other -D FLASH_WARPS,
// FLASH_BK and FLASH_STAGES; hd 256 has one fixed tile that fits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The tile at head dims up to 128: warps a block, keys a tile, buffers in
// each of the K and V rings. A sweep's variant sets all three with -D for
// every head dim up to 128; the path's are constants by head dim.
template <int HD>
struct Choice {
#ifdef FLASH_WARPS
    static constexpr int WARPS = FLASH_WARPS, BK = FLASH_BK,
                         STAGES = FLASH_STAGES;
#else
    // hd 16 and 32 (pnpcoin-micro and pnpcoin-demo, S = 16 and 32: a
    // launch's latency) take small tiles; hd 64 and 128 the tile that
    // reuses each K and V tile most
    static constexpr int WARPS = HD <= 32 ? 4 : 8;
    static constexpr int BK = HD <= 32 ? 32 : 64;
    static constexpr int STAGES = 1;
#endif
};

template <int HD>
struct Tile {
    static constexpr bool WIDE = HD > 128;
    static constexpr int TM = WIDE ? 4 : 8;            // query rows a thread
    static constexpr int WARPS = WIDE ? 8 : Choice<HD>::WARPS;
    static constexpr int BK = WIDE ? 32 : Choice<HD>::BK;    // keys a tile
    static constexpr int STAGES = WIDE ? 1 : Choice<HD>::STAGES;
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int ROWS_PER_WARP = 2 * TM;
    static constexpr int BQ = WARPS * ROWS_PER_WARP;   // query rows a block
    static constexpr int TN = BK / 16;                 // keys a thread
    static constexpr int VW = HD == 16 ? 1 : HD == 32 ? 2 : 4;   // columns a V load
    static constexpr int VC = HD / (16 * VW);          // V loads a key
    static constexpr int LD = HD + 4;                  // Q, K, V row stride
    static constexpr int PK = 32;                      // keys of P at a time
    static constexpr int PS = PK + 16;                 // P row stride
    static constexpr int SMEM =
        4 * (BQ * LD + 2 * STAGES * BK * LD + BQ * PS);
    static_assert(BK % PK == 0, "keys a tile");
    static_assert(STAGES >= 1, "stages");
    static_assert(SMEM <= 227 * 1024, "tile fits shared memory");
};

__device__ __forceinline__ void cp_async16(float* smem, const void* gmem,
                                           bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    const int bytes = valid ? 16 : 0;   // 0: zero-fill, nothing read
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 bf16x4_to_float4(uint32_t lo, uint32_t hi) {
    // little endian: the low half of each word is the first element
    return make_float4(__uint_as_float(lo << 16),
                       __uint_as_float(lo & 0xffff0000u),
                       __uint_as_float(hi << 16),
                       __uint_as_float(hi & 0xffff0000u));
}

// Rows [r0, r0 + ROWS) of a (., heads, HD) tensor, row r at base + r *
// stride elements, into dst[ROWS][LD] as float32; rows at or past n are
// zero. float32 goes by cp.async (the caller commits the group); bfloat16
// through registers.
template <typename T, int HD, int ROWS, int THREADS, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const T* base,
                                           size_t stride, int r0, int n) {
    if constexpr (sizeof(T) == 4) {
        constexpr int CPR = HD / 4;       // 16-byte pieces a row
#pragma unroll 4
        for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
            const int r = c / CPR, col = (c % CPR) * 4;
            const bool valid = r0 + r < n;
            const T* src = valid ? base + (size_t)(r0 + r) * stride + col
                                 : base;
            cp_async16(dst + r * LD + col, src, valid);
        }
    } else {
        constexpr int CPR = HD / 8;
#pragma unroll 2
        for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
            const int r = c / CPR, col = (c % CPR) * 8;
            uint4 raw = make_uint4(0u, 0u, 0u, 0u);
            if (r0 + r < n)
                raw = __ldg(reinterpret_cast<const uint4*>(
                    base + (size_t)(r0 + r) * stride + col));
            float4* d = reinterpret_cast<float4*>(dst + r * LD + col);
            d[0] = bf16x4_to_float4(raw.x, raw.y);
            d[1] = bf16x4_to_float4(raw.z, raw.w);
        }
    }
}

// A store of VW output columns.
__device__ __forceinline__ void store_cols(float* dst, const float* x, int n) {
    if (n == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    else if (n == 2)
        *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
    else
        dst[0] = x[0];
}

__device__ __forceinline__ void store_cols(__nv_bfloat16* dst, const float* x,
                                           int n) {
    if (n == 1) {
        dst[0] = __float2bfloat16_rn(x[0]);
        return;
    }
    const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    if (n == 4) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&a);
        packed.y = *reinterpret_cast<const uint32_t*>(&b);
        *reinterpret_cast<uint2*>(dst) = packed;
    } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = a;
    }
}

// VW floats of shared memory at p.
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

__device__ __forceinline__ float lane_of(const float4& x, int i) {
    return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// A warp owns ROWS_PER_WARP = 2 TM rows; lane (ty, tx) = (lane / 16, lane
// % 16) owns rows row0 + 2 i (i < TM), keys tx + 16 j (j < TN) of each
// score tile and columns VW tx + 16 VW c (c < VC) of the output. The 8
// lanes of a quarter-warp share their rows (one address for each Q or P
// load, a broadcast) and read 8 neighbouring keys or column groups.
template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(Tile<HD>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int T_len, int H, int Kv,
                 int causal, int window, float scale_log2) {
    using C = Tile<HD>;
    constexpr int TM = C::TM, TN = C::TN, VW = C::VW, VC = C::VC;
    constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, PS = C::PS, PK = C::PK;
    constexpr int NS = C::STAGES, THREADS = C::THREADS;
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;                     // [BQ][LD]
    float* Ks = Qs + BQ * LD;             // [NS][BK][LD]
    float* Vs = Ks + NS * BK * LD;        // [NS][BK][LD]
    float* Ps = Vs + NS * BK * LD;        // [BQ][PS]

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tx = lane & 15, ty = lane >> 4;
    const int row0 = warp * C::ROWS_PER_WARP + ty;   // rows row0 + 2 i
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / Kv);
    const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)Kv * HD;
    const T* qb = q + ((size_t)b * S * H + h) * HD;
    const T* kb = k + ((size_t)b * T_len * Kv + kvh) * HD;
    const T* vb = v + ((size_t)b * T_len * Kv + kvh) * HD;

    const int q_last = min(q0 + BQ, S) - 1;
    int n_tiles = (T_len + BK - 1) / BK;
    if (causal) n_tiles = min(n_tiles, q_last / BK + 1);
    // the band of the block's first row starts at key q0 - window + 1; a
    // later row whose keys all lie past a tile starts with that tile fully
    // masked, which the next tile's rescale (alpha = 0) wipes out
    const int kt_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
    const int count = n_tiles - kt_first;

    // Q, then K_0, V_0, ..., K_{NS-2}, V_{NS-2}, K_{NS-1}: one commit group
    // each (empty past the last tile), so the waits below count the same
    // number of younger groups at every tile
    stage_rows<T, HD, BQ, THREADS, LD>(Qs, qb, q_stride, q0, S);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        if (j < count)
            stage_rows<T, HD, BK, THREADS, LD>(Ks + j * BK * LD, kb,
                                               kv_stride, (kt_first + j) * BK,
                                               T_len);
        cp_async_commit();
        if (j + 1 < NS) {
            if (j < count)
                stage_rows<T, HD, BK, THREADS, LD>(
                    Vs + j * BK * LD, vb, kv_stride, (kt_first + j) * BK,
                    T_len);
            cp_async_commit();
        }
    }

    float m[TM], l[TM], acc[TM][VC * VW];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < VC * VW; ++c) acc[i][c] = 0.f;
    }

    for (int j = 0; j < count; ++j) {
        const int k0 = (kt_first + j) * BK;
        const int slot = j % NS;
        cp_async_wait<2 * NS - 2>();       // K_j (and Q) landed
        __syncthreads();                   // ... for every thread; PV(j - 1)
                                           // is done with its V buffer
        {
            const int jn = j + NS - 1;     // V_jn into the buffer PV(j - 1) read
            if (jn < count)
                stage_rows<T, HD, BK, THREADS, LD>(
                    Vs + (jn % NS) * BK * LD, vb, kv_stride,
                    (kt_first + jn) * BK, T_len);
            cp_async_commit();
        }

        // scores: s[i][jj] = q[row0 + 2 i] . k[k0 + tx + 16 jj]
        float s[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int jj = 0; jj < TN; ++jj) s[i][jj] = 0.f;
        const float* Kt = Ks + slot * BK * LD;
#pragma unroll 8
        for (int d = 0; d < HD; d += 4) {
            float4 qf[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i)
                qf[i] = *reinterpret_cast<const float4*>(
                    Qs + (row0 + 2 * i) * LD + d);
#pragma unroll
            for (int jj = 0; jj < TN; ++jj) {
                const float4 kf = *reinterpret_cast<const float4*>(
                    Kt + (tx + 16 * jj) * LD + d);
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    s[i][jj] = fmaf(qf[i].x, kf.x, s[i][jj]);
                    s[i][jj] = fmaf(qf[i].y, kf.y, s[i][jj]);
                    s[i][jj] = fmaf(qf[i].z, kf.z, s[i][jj]);
                    s[i][jj] = fmaf(qf[i].w, kf.w, s[i][jj]);
                }
            }
        }

        // online softmax, base 2. The 16 lanes of a row are one half of
        // the warp; xor shuffles up to 8 stay inside it.
        const bool edge = k0 + BK > T_len || (causal && k0 + BK - 1 > q0) ||
                          (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int qp = q0 + row0 + 2 * i;
            float mx = NEG_INF;
#pragma unroll
            for (int jj = 0; jj < TN; ++jj) {
                float x = s[i][jj] * scale_log2;
                if (edge) {
                    const int kp = k0 + tx + 16 * jj;
                    const bool keep = kp < T_len && (!causal || kp <= qp) &&
                                      (window <= 0 || kp > qp - window);
                    x = keep ? x : NEG_INF;
                }
                s[i][jj] = x;
                mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = exp2f(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int jj = 0; jj < TN; ++jj) {
                s[i][jj] = exp2f(s[i][jj] - m_new);
                sum += s[i][jj];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = alpha * l[i] + sum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < VC * VW; ++c) acc[i][c] *= alpha;
        }

        cp_async_wait<2 * NS - 2>();       // V_j landed
        __syncthreads();                   // ... for every thread; S(j) is
                                           // done with its K buffer
        {
            const int jn = j + NS;         // K_jn into the buffer S(j) read
            if (jn < count)
                stage_rows<T, HD, BK, THREADS, LD>(
                    Ks + slot * BK * LD, kb, kv_stride, (kt_first + jn) * BK,
                    T_len);
            cp_async_commit();
        }

        // out += P V, PK keys at a time: the warp's P rows of those keys
        // into shared memory (only this warp reads them), then acc[i][VW c
        // + e] += p[row0 + 2 i][key] v[key][VW tx + 16 VW c + e], keys in
        // order
        const float* Vt = Vs + slot * BK * LD + VW * tx;
#pragma unroll
        for (int h = 0; h < BK / PK; ++h) {
            __syncwarp();                  // the last chunk's P is consumed
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int jj = 0; jj < PK / 16; ++jj)
                    Ps[(row0 + 2 * i) * PS + tx + 16 * jj] =
                        s[i][h * (PK / 16) + jj];
            __syncwarp();
#pragma unroll 4
            for (int jk = 0; jk < PK; jk += 4) {
                float4 pf[TM];
#pragma unroll
                for (int i = 0; i < TM; ++i)
                    pf[i] = *reinterpret_cast<const float4*>(
                        Ps + (row0 + 2 * i) * PS + jk);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
#pragma unroll
                    for (int c = 0; c < VC; ++c) {
                        float vf[VW];
                        load_cols<VW>(Vt + (h * PK + jk + u) * LD
                                          + 16 * VW * c, vf);
#pragma unroll
                        for (int i = 0; i < TM; ++i) {
                            const float p = lane_of(pf[i], u);
#pragma unroll
                            for (int e = 0; e < VW; ++e)
                                acc[i][VW * c + e] =
                                    fmaf(p, vf[e], acc[i][VW * c + e]);
                        }
                    }
                }
            }
        }
    }
    cp_async_wait<0>();                    // no copy outlives the block

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int qp = q0 + row0 + 2 * i;
        if (qp >= S) continue;
        if constexpr (LSE) {
            // m and l are the row's own on all 16 of its lanes; in the log2
            // domain the row's log-sum-exp is m + log2 l. A row that saw no
            // key keeps m = NEG_INF and writes it, as the plain version does
            if (tx == 0)
                lse[((size_t)b * H + h) * S + qp] =
                    m[i] == NEG_INF ? NEG_INF
                                    : (m[i] + log2f(l[i])) * (1.f / LOG2E);
        }
        const float inv = 1.f / fmaxf(l[i], 1e-20f);
        T* dst = o + ((size_t)b * S + qp) * q_stride + (size_t)h * HD + VW * tx;
#pragma unroll
        for (int c = 0; c < VC; ++c) {
            float x[VW];
#pragma unroll
            for (int e = 0; e < VW; ++e) x[e] = acc[i][VW * c + e] * inv;
            store_cols(dst + 16 * VW * c, x, VW);
        }
    }
}

template <typename T, int HD, bool LSE = false>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t S, int64_t T_len, int H, int Kv, int causal, int window,
           cudaStream_t stream, float* lse = nullptr) {
    using C = Tile<HD>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned int)((S + C::BQ - 1) / C::BQ), (unsigned int)H,
                    (unsigned int)B);
    flash_fwd_kernel<T, HD, LSE><<<grid, C::THREADS, C::SMEM, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, (int)S,
        (int)T_len, H, Kv, causal, window, LOG2E / sqrtf((float)HD));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int64_t B,
              int64_t S, int64_t T_len, int H, int Kv, int hd, int causal,
              int window, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, o, B, S, T_len, H, Kv, causal, window, stream);
        case 32: return launch<T, 32>(q, k, v, o, B, S, T_len, H, Kv, causal, window, stream);
        case 64: return launch<T, 64>(q, k, v, o, B, S, T_len, H, Kv, causal, window, stream);
        case 128: return launch<T, 128>(q, k, v, o, B, S, T_len, H, Kv, causal, window, stream);
        case 256: return launch<T, 256>(q, k, v, o, B, S, T_len, H, Kv, causal, window, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int HD>
int info(int32_t* out) {
    using C = Tile<HD>;
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, flash_fwd_kernel<float, HD, false>);
    if (err != cudaSuccess) return (int)err;
    out[0] = C::BQ;
    out[1] = C::BK;
    out[2] = C::STAGES;
    out[3] = C::THREADS;
    out[4] = C::SMEM;
    out[5] = attr.numRegs;
    out[6] = (int32_t)attr.localSizeBytes;
    return 0;
}

}  // namespace

// The tile of the float32 kernel at head dim `hd`, as 7 ints: query rows a
// block, keys a tile, stages of the K and V rings, threads, dynamic shared
// bytes, and the registers a thread and local (spilled) bytes the runtime
// reports.
extern "C" int pnp_flash_attention_info(int32_t hd, int32_t* out) {
    switch (hd) {
        case 16: return info<16>(out);
        case 32: return info<32>(out);
        case 64: return info<64>(out);
        case 128: return info<128>(out);
        case 256: return info<256>(out);
        default: return (int)cudaErrorInvalidValue;
    }
}

// q: (B, S, H, hd); k, v: (B, T, Kv, hd); out: (B, S, H, hd); contiguous,
// 16-byte aligned, one dtype: 0 = float32, 1 = bfloat16. hd in {16, 32,
// 64, 128, 256}; H % Kv == 0; window 0 for none. Launches on `stream` and
// returns cudaGetLastError().
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

// The training forward: as pnp_flash_attention_fwd on float32 at hd 16,
// 32, 64 or 128, and also each row's log-sum-exp of its scaled scores into lse,
// float32 (B, H, S), natural-log units.
extern "C" int pnp_flash_attention_fwd_lse(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int64_t B, int64_t S,
                                           int64_t T, int32_t H, int32_t Kv,
                                           int32_t hd, int32_t causal,
                                           int32_t window, void* stream) {
    if (B < 0 || S < 0 || T < 1 || H < 1 || Kv < 1 || H % Kv || window < 0 ||
        S > INT32_MAX || T > INT32_MAX || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || S == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    float* l = (float*)lse;
    switch (hd) {
        case 16: return launch<float, 16, true>(q, k, v, out, B, S, T, H, Kv, causal, window, st, l);
        case 32: return launch<float, 32, true>(q, k, v, out, B, S, T, H, Kv, causal, window, st, l);
        case 64: return launch<float, 64, true>(q, k, v, out, B, S, T, H, Kv, causal, window, st, l);
        case 128: return launch<float, 128, true>(q, k, v, out, B, S, T, H, Kv, causal, window, st, l);
        default: return (int)cudaErrorInvalidValue;
    }
}
