// Attention backward for bfloat16 at head dim 256 on Hopper's tensor cores
// (`mma.sync`): dQ, dK and dV of the attention flash_attention_tc.cu
// computes, from q, k, v, its output o, the output's gradient dO and the row
// log-sum-exp its training instance saves.
//
// Replaces no TPU kernel on its own: the reference has no Pallas backward;
// jax.grad differentiates repro.models.attention.chunked_attention (the
// function of the Pallas forward, src/repro/kernels/flash_attention.py:28).
// The port's bf16 training step reaches it through
// kernels/flash_attention.py's autograd Function at head dim 256:
// recurrentgemma-2b's 8 local-attention layers (10 heads over 1, window
// 2048). flash_attention_tc_bwd.cu takes head dims 64 and 128; its design
// (128 resident keys of K and V, 64 x hd float32 dK and dV accumulators a
// consumer warpgroup) does not fit at 256.
//
// q, o, dO, dQ (B, S, H, hd); k, v, dK, dV (B, T, Kv, hd); all bfloat16,
// contiguous, 16-byte aligned; lse (B, H, S) float32. Scores are scaled by
// 1/sqrt(hd); with `causal` query s sees keys t <= s (queries at offset 0);
// with `window` > 0 only keys t > s - window. Query head h reads KV head
// h / (H / Kv). Per (query s, key t) pair the mask keeps:
//   P = exp(q.k / sqrt(hd) - lse_s), D_s = dO_s . o_s (float32),
//   dV_t += P dO_s,  dP = dO_s . v_t,  dS = P (dP - D_s),
//   dQ_s += dS k_t / sqrt(hd),  dK_t += dS q_s / sqrt(hd).
//
// What bounds it on an H100: at the training call (B 16, S = T 256, 10
// heads over 1, hd 256, causal) the five products are ~2.8e10 flops (less
// the tiles past the diagonal), 0.028 ms at the 989 TFLOP/s of the bf16
// tensor cores, against ~105 MB of q, k, v, o, dO read and dq, dk, dv
// written (0.031 ms at 3.35 TB/s): near the ridge. At S = T = 4096 with a
// window of 2048 the products bound it.
//
// The design, a simple one that is right (the first bf16 backward's, at
// hd 64 and 128, widened), three launches:
// - tc_dot_kernel: D = rowsum(dO o) in float32 of every row (16 lanes a row,
//   a fixed shuffle tree) into a workspace;
// - tc_dkv_kernel: a block of 4 warps owns 64 keys of one (batch row, KV
//   head) and one half of the head dim's columns of dK and dV (DC = 128):
//   the two halves of a key tile are two blocks, each recomputing the
//   scores, so a thread's dK and dV accumulators are 16 keys x 128 columns
//   (128 registers), as at hd 128. Its K and V tiles (64 x 256, rows padded
//   by 16 bytes, 33 KB each) stay in shared memory while it walks the query
//   tiles (64 rows) that see one of its keys in ascending order, the group's
//   heads inside. For each (query tile, head) pair, Q, dO, lse and D come by
//   cp.async into shared memory (one barrier a pair; 133 KB in all); each
//   warp owns 16 keys and, 32 queries at a time, runs S^T = K Q^T and dP^T
//   = V dO^T as `mma.sync` m16n8k16 bf16 products with float32
//   accumulators (operands by `ldmatrix`), P and dS in float32 registers,
//   then dV += P^T dO and dK += dS^T Q over its half's columns, P and dS
//   rounded to bf16 as the A operand straight from the registers that held
//   S and dP. The first half's block writes dS^T to a workspace, bf16 (B, H,
//   T_pad, S_pad);
// - tc_dq_kernel: a block owns 64 query rows of one (batch row, head) and
//   walks the key tiles that see them in ascending order: dQ += dS K from
//   the stored dS^T (`ldmatrix.trans` gives the A fragment) and K; a
//   thread's accumulators are 16 rows x 256 columns (128 registers).
// Every sum runs in a fixed order with no atomics (dK and dV over the query
// tiles and the group's heads in the loop's order, dQ over key tiles in
// ascending order), so two launches give the same bits and a miner and its
// verifier agree. A (query tile, key tile) pair is computed iff some pair of
// it is inside the mask's band (`visible`), the same rule in both passes,
// so tc_dq_kernel reads only dS^T tiles tc_dkv_kernel wrote.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;        // query rows a tile
constexpr int BK = 64;        // keys a tile
constexpr int WARPS = 4;      // a warp owns 16 keys (dkv) or 16 rows (dq)
constexpr int THREADS = 32 * WARPS;
constexpr int QH = 32;        // queries a dkv warp computes at a time
constexpr int HD = 256;       // the head dim
constexpr int DC = 128;       // columns of dK and dV a dkv block accumulates
constexpr int NH = HD / DC;   // dkv blocks a key tile

// Row stride in bf16 of a shared tile of HD columns: 16 bytes of padding, so
// the 8 rows an ldmatrix reads start in 8 different bank groups.
__host__ __device__ constexpr int lds() { return HD + 8; }

__host__ __device__ constexpr int dkv_smem() { return 4 * BK * lds() * 2 + 2 * BQ * 4; }
__host__ __device__ constexpr int dq_smem() { return BK * (BQ + 8) * 2 + BK * lds() * 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
    const int bytes = valid ? 16 : 0;   // 0: zero-fill, nothing read
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
                 "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of a (., heads, HD) bf16 tensor, row r at base + r *
// stride elements, into dst[ROWS][lds()] by cp.async; rows at or past n
// are zero. The caller commits the group.
template <int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* base,
                                           size_t stride, int r0, int n) {
    constexpr int CPR = HD / 8;   // 16-byte pieces a row
    for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
        const int r = c / CPR, col = (c % CPR) * 8;
        const bool valid = r0 + r < n;
        cp_async16(dst + r * lds() + col,
                   valid ? base + (size_t)(r0 + r) * stride + col : base, valid);
    }
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: lane i gets row i / 4, columns 2 (i % 4)
// and + 1 of each; transposed: rows 2 (i % 4) and + 1 of column i / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row-major fragment) b (16 x 8,
// bf16, column-major fragment). Fragments (g = lane / 4, t = lane % 4): a
// regs (row g, cols 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..);
// b regs (rows 2t.., col g), (2t + 8.., g); d (row g, cols 2t, 2t + 1),
// (g + 8, 2t, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats to a bf16 pair, round to nearest even; `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

// Whether the (query tile q0, key tile k0) pair holds a pair inside the
// mask's band: the rule both passes use to choose their tiles.
__device__ __forceinline__ bool visible(int q0, int k0, int S, int T, int causal,
                                        int window) {
    const int q_last = min(q0 + BQ, S) - 1, k_last = min(k0 + BK, T) - 1;
    return !(causal && k0 > q_last) && !(window > 0 && k_last <= q0 - window);
}

// The first launch: D = rowsum(dO o) of every row (a row's 16 lanes, a
// fixed shuffle tree) into Dws (B, H, S).
__global__ void __launch_bounds__(256)
tc_dot_kernel(const __nv_bfloat16* __restrict__ o,
           const __nv_bfloat16* __restrict__ dout, float* __restrict__ Dws,
           int64_t n_rows, int S, int H) {
    constexpr int PER = HD / 16;     // elements a lane: 16
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int tx = threadIdx.x & 15;
    const int64_t r = tid >> 4;      // row of (B, S, H) in memory order
    const bool live = r < n_rows;
    float part = 0.f;
    if (live) {
        uint32_t ow[PER / 2], gw[PER / 2];
        const size_t at = (size_t)r * HD + PER * tx;
#pragma unroll
        for (int i = 0; i < PER / 8; ++i) {
            const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + at) + i);
            const uint4 b = __ldg(reinterpret_cast<const uint4*>(dout + at) + i);
            ow[4 * i] = a.x; ow[4 * i + 1] = a.y; ow[4 * i + 2] = a.z; ow[4 * i + 3] = a.w;
            gw[4 * i] = b.x; gw[4 * i + 1] = b.y; gw[4 * i + 2] = b.z; gw[4 * i + 3] = b.w;
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
    if (!live) return;
    const int h = (int)(r % H);
    const int64_t bs = r / H;
    const int s = (int)(bs % S);
    const int64_t b = bs / S;
    if (tx == 0) Dws[(b * H + h) * S + s] = part;
}

// The key pass: dK and dV of one key tile, and each (query tile, head)
// pair's dS^T into the workspace for tc_dq_kernel.
__global__ void __launch_bounds__(THREADS)
tc_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const float* __restrict__ lse,
           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ Dws,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           __nv_bfloat16* __restrict__ dsT, int S, int T, int H, int Kv,
           int S_pad, int T_pad, int causal, int window, float scale_log2,
           float scale) {
    constexpr int LD = lds();
    constexpr int NT = DC / 8;        // n-tiles of an accumulator row
    extern __shared__ __align__(16) uint8_t smem[];
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [BK][LD]
    __nv_bfloat16* Vs = Ks + BK * LD;                              // [BK][LD]
    __nv_bfloat16* Qs = Vs + BK * LD;                              // [BQ][LD]
    __nv_bfloat16* Gs = Qs + BQ * LD;                              // [BQ][LD]: dO
    float* Ls = reinterpret_cast<float*>(Gs + BQ * LD);            // [BQ]: lse log2 e
    float* Dsh = Ls + BQ;                                          // [BQ]: D

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int kt = blockIdx.x / NH, kvh = blockIdx.y, b = blockIdx.z;
    const int c0 = (blockIdx.x % NH) * DC;       // the block's columns: c0 ..
    const bool writes_ds = c0 == 0;
    const int k0 = kt * BK, kw = warp * 16;      // the warp's keys: k0 + kw ..
    const int G = H / Kv;
    const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)Kv * HD;

    stage_rows<BK>(Ks, k + ((size_t)b * T * Kv + kvh) * HD, kv_stride, k0, T);
    stage_rows<BK>(Vs, v + ((size_t)b * T * Kv + kvh) * HD, kv_stride, k0, T);
    cp_async_commit();

    float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

    // ldmatrix row addresses: A (the warp's keys) and the plain B of the
    // score products (rows of 8 queries), the transposed B of the
    // accumulator products (rows of 8 queries by 8 columns)
    const int a_row = kw + lane % 8 + 8 * ((lane / 8) & 1), a_col = 8 * (lane / 16);
    const int b_row = lane % 8 + 8 * (lane / 16), b_col = 8 * ((lane / 8) & 1);
    const int t_row = lane % 8 + 8 * ((lane / 8) & 1), t_col = 8 * (lane / 16);

    const int n_qt = (S + BQ - 1) / BQ;
    for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        if (!visible(q0, k0, S, T, causal, window)) continue;
        for (int hg = 0; hg < G; ++hg) {
            const int h = kvh * G + hg;
            __syncthreads();      // the last pair is done with Qs, Gs, Ls, Dsh
            stage_rows<BQ>(Qs, q + ((size_t)b * S * H + h) * HD, q_stride, q0, S);
            stage_rows<BQ>(Gs, dout + ((size_t)b * S * H + h) * HD, q_stride, q0,
                               S);
            cp_async_commit();
            if (threadIdx.x < BQ) {
                const int qp = q0 + threadIdx.x;
                const size_t at = ((size_t)b * H + h) * S + qp;
                Ls[threadIdx.x] = qp < S ? lse[at] * LOG2E : 0.f;
                Dsh[threadIdx.x] = qp < S ? Dws[at] : 0.f;
            }
            cp_async_wait_all();
            __syncthreads();

            __nv_bfloat16* ds_bh = dsT + ((size_t)b * H + h) * T_pad * S_pad;
#pragma unroll 1
            for (int qh = 0; qh < BQ; qh += QH) {
                // S^T = K Q^T and dP^T = V dO^T: 16 keys by QH queries
                float s[QH / 8][4], dp[QH / 8][4];
#pragma unroll
                for (int n = 0; n < QH / 8; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk) {
                    uint32_t ka[4], va[4];
                    ldsm_x4(ka, Ks + a_row * LD + kk * 16 + a_col);
                    ldsm_x4(va, Vs + a_row * LD + kk * 16 + a_col);
#pragma unroll
                    for (int np = 0; np < QH / 16; ++np) {
                        uint32_t qb[4], gb[4];
                        const int off = (qh + np * 16 + b_row) * LD + kk * 16 + b_col;
                        ldsm_x4(qb, Qs + off);
                        ldsm_x4(gb, Gs + off);
                        mma(s[2 * np], ka, qb[0], qb[1]);
                        mma(s[2 * np + 1], ka, qb[2], qb[3]);
                        mma(dp[2 * np], va, gb[0], gb[1]);
                        mma(dp[2 * np + 1], va, gb[2], gb[3]);
                    }
                }
                // P and dS in float32, masked by select (a row that sees no
                // key has lse -1e30: its P is never computed)
#pragma unroll
                for (int n = 0; n < QH / 8; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int key = k0 + kw + g + 8 * (e / 2);
                        const int ql = qh + n * 8 + 2 * t4 + (e & 1);
                        const int qp = q0 + ql;
                        const bool keep = qp < S && key < T && (!causal || key <= qp) &&
                                          (window <= 0 || key > qp - window);
                        const float p =
                            keep ? exp2f(fmaf(s[n][e], scale_log2, -Ls[ql])) : 0.f;
                        s[n][e] = p;
                        dp[n][e] = p * (dp[n][e] - Dsh[ql]);
                    }
                // the A fragments of P^T and dS^T, 16 queries a fragment
                uint32_t pa[QH / 16][4], da[QH / 16][4];
#pragma unroll
                for (int c = 0; c < QH / 16; ++c) {
                    pa[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
                    pa[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
                    pa[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
                    pa[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
                    da[c][0] = pack_bf16(dp[2 * c][0], dp[2 * c][1]);
                    da[c][1] = pack_bf16(dp[2 * c][2], dp[2 * c][3]);
                    da[c][2] = pack_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1]);
                    da[c][3] = pack_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3]);
                }
                // dS^T (keys by queries) to the workspace, the bf16 pairs
                // the products below take (one block of the key tile's)
                if (writes_ds) {
#pragma unroll
                    for (int c = 0; c < QH / 16; ++c)
#pragma unroll
                        for (int half = 0; half < 2; ++half)
#pragma unroll
                            for (int r = 0; r < 2; ++r) {
                                const int key = k0 + kw + g + 8 * r;
                                const int col = q0 + qh + c * 16 + half * 8 + 2 * t4;
                                *reinterpret_cast<uint32_t*>(ds_bh + (size_t)key * S_pad +
                                                             col) = da[c][2 * half + r];
                            }
                }
                // dV += P^T dO and dK += dS^T Q over the block's columns,
                // 16 queries a step
#pragma unroll
                for (int c = 0; c < QH / 16; ++c)
#pragma unroll
                    for (int np = 0; np < DC / 16; ++np) {
                        uint32_t gb[4], qb[4];
                        const int off = (qh + c * 16 + t_row) * LD + c0 + np * 16 + t_col;
                        ldsm_x4_t(gb, Gs + off);
                        ldsm_x4_t(qb, Qs + off);
                        mma(dv_acc[2 * np], pa[c], gb[0], gb[1]);
                        mma(dv_acc[2 * np + 1], pa[c], gb[2], gb[3]);
                        mma(dk_acc[2 * np], da[c], qb[0], qb[1]);
                        mma(dk_acc[2 * np + 1], da[c], qb[2], qb[3]);
                    }
            }
        }
    }
    cp_async_wait_all();   // no copy outlives the block (a tile that sees no query)

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = k0 + kw + g + 8 * r;
        if (key >= T) continue;
        const size_t at = ((size_t)b * T + key) * kv_stride + (size_t)kvh * HD + c0 + 2 * t4;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            *reinterpret_cast<uint32_t*>(dk + at + n * 8) =
                pack_bf16(dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + at + n * 8) =
                pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
        }
    }
}

// The dQ pass: dQ = dS K / sqrt(hd) from the dS^T tiles tc_dkv_kernel stored.
// A block owns 64 query rows of one (batch row, head), a warp 16 of them,
// and walks the key tiles that see them in ascending order; each tile's dS^T
// (64 keys x 64 queries) and K come by cp.async into shared memory.
__global__ void __launch_bounds__(THREADS)
tc_dq_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ dsT,
          __nv_bfloat16* __restrict__ dq, int S, int T, int H, int Kv, int S_pad,
          int T_pad, int causal, int window, float scale) {
    constexpr int LD = lds(), SS = BQ + 8;
    constexpr int NT = HD / 8;
    extern __shared__ __align__(16) uint8_t smem[];
    __nv_bfloat16* DSs = reinterpret_cast<__nv_bfloat16*>(smem);   // [BK][SS]
    __nv_bfloat16* Ks = DSs + BK * SS;                              // [BK][LD]

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int q0 = qt * BQ, qw = warp * 16;     // the warp's rows: q0 + qw ..
    const int kvh = h / (H / Kv);
    const size_t kv_stride = (size_t)Kv * HD;
    const __nv_bfloat16* kb = k + ((size_t)b * T * Kv + kvh) * HD;
    const __nv_bfloat16* ds_bh = dsT + ((size_t)b * H + h) * T_pad * S_pad;

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // ldmatrix.trans row addresses: dS^T as the A operand (rows of 8 keys
    // by 8 queries), K as the B operand (rows of 8 keys by 8 columns)
    const int a_row = lane % 8 + 8 * (lane / 16), a_col = qw + 8 * ((lane / 8) & 1);
    const int t_row = lane % 8 + 8 * ((lane / 8) & 1), t_col = 8 * (lane / 16);

    const int n_kt = (T + BK - 1) / BK;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        if (!visible(q0, k0, S, T, causal, window)) continue;
        __syncthreads();          // the last tile is done with DSs and Ks
        for (int c = threadIdx.x; c < BK * (BQ / 8); c += THREADS) {
            const int r = c / (BQ / 8), col = (c % (BQ / 8)) * 8;
            cp_async16(DSs + r * SS + col, ds_bh + (size_t)(k0 + r) * S_pad + q0 + col,
                       true);
        }
        stage_rows<BK>(Ks, kb, kv_stride, k0, T);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
            uint32_t a[4];
            ldsm_x4_t(a, DSs + (kc * 16 + a_row) * SS + a_col);
#pragma unroll
            for (int np = 0; np < HD / 16; ++np) {
                uint32_t kf[4];
                ldsm_x4_t(kf, Ks + (kc * 16 + t_row) * LD + np * 16 + t_col);
                mma(acc[2 * np], a, kf[0], kf[1]);
                mma(acc[2 * np + 1], a, kf[2], kf[3]);
            }
        }
    }

    const size_t q_stride = (size_t)H * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qp = q0 + qw + g + 8 * r;
        if (qp >= S) continue;
        __nv_bfloat16* dst = dq + ((size_t)b * S + qp) * q_stride + (size_t)h * HD + 2 * t4;
#pragma unroll
        for (int n = 0; n < NT; ++n)
            *reinterpret_cast<uint32_t*>(dst + n * 8) =
                pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
}

int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* Dws, void* dsT, int64_t B, int64_t S, int64_t T, int H, int Kv,
           int causal, int window, cudaStream_t stream) {
    using bf = __nv_bfloat16;
    const float scale = 1.f / sqrtf((float)HD);
    cudaError_t err = cudaFuncSetAttribute(
        tc_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem());
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(tc_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem());
    if (err != cudaSuccess) return (int)err;
    const int64_t n_rows = B * S * H;
    const int S_pad = (int)((S + BQ - 1) / BQ * BQ), T_pad = (int)((T + BK - 1) / BK * BK);
    tc_dot_kernel<<<(unsigned int)((n_rows * 16 + 255) / 256), 256, 0, stream>>>(
        (const bf*)o, (const bf*)dout, Dws, n_rows, (int)S, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 gk((unsigned int)(T_pad / BK * NH), (unsigned int)Kv, (unsigned int)B);
    tc_dkv_kernel<<<gk, THREADS, dkv_smem(), stream>>>(
        (const bf*)q, (const bf*)k, (const bf*)v, lse, (const bf*)dout, Dws, (bf*)dk,
        (bf*)dv, (bf*)dsT, (int)S, (int)T, H, Kv, S_pad, T_pad, causal, window,
        LOG2E * scale, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 gq((unsigned int)(S_pad / BQ), (unsigned int)H, (unsigned int)B);
    tc_dq_kernel<<<gq, THREADS, dq_smem(), stream>>>(
        (const bf*)k, (const bf*)dsT, (bf*)dq, (int)S, (int)T, H, Kv, S_pad, T_pad,
        causal, window, scale);
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

int info(int32_t* out) {
    out[0] = BQ;
    out[1] = BK;
    out[2] = dkv_smem();
    out[3] = dq_smem();
    return resources(tc_dot_kernel, out + 4) | resources(tc_dkv_kernel, out + 6) |
           resources(tc_dq_kernel, out + 8);
}

}  // namespace

// The tiles, as 10 ints: query rows and keys a tile, the dynamic shared
// bytes of tc_dkv_kernel and tc_dq_kernel, then the registers a thread and
// local (spilled) bytes the runtime reports for tc_dot_kernel, tc_dkv_kernel
// and tc_dq_kernel.
extern "C" int pnp_flash_attention_mma_bwd_info(int32_t* out) { return info(out); }

// q, o, dout, dq: (B, S, H, 256); k, v, dk, dv: (B, T, Kv, 256); bfloat16,
// contiguous, 16-byte aligned; lse: (B, H, S) float32; H % Kv == 0; window 0
// for none. Workspaces (the kernels fill them): Dws float32 (B, H, S); dsT
// bf16 (B, H, T_pad, S_pad), T and S rounded up to 64. Launches
// tc_dot_kernel, tc_dkv_kernel and tc_dq_kernel on `stream`; returns
// cudaGetLastError() (or the error that kept a kernel from launching).
extern "C" int pnp_flash_attention_mma_bwd(const void* q, const void* k, const void* v,
                                           const void* o, const void* lse,
                                           const void* dout, void* dq, void* dk,
                                           void* dv, void* Dws, void* dsT, int64_t B,
                                           int64_t S, int64_t T, int32_t H, int32_t Kv,
                                           int32_t causal, int32_t window, void* stream) {
    if (B < 0 || S < 0 || T < 1 || H < 1 || Kv < 1 || H % Kv || window < 0 ||
        S > INT32_MAX - BQ || T > INT32_MAX - BK || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
         (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)dsT) % 16)
        return (int)cudaErrorMisalignedAddress;
    if (B == 0 || S == 0) return 0;
    return launch(q, k, v, o, (const float*)lse, dout, dq, dk, dv, (float*)Dws, dsT, B, S,
                  T, H, Kv, causal, window, (cudaStream_t)stream);
}
