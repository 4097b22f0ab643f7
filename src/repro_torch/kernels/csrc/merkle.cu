// The wide levels of Merkle trees (B same-width trees at once), reduced in
// one launch: SHA-256 of each pair of child digests, level after level,
// down to the reference's cutover width.
//
// Replaces: src/repro/kernels/merkle.py `_node_hash`, traced under
// `_tree_fn` (one tree) and `_forest_fn` (B trees). The JAX package writes
// it as jitted jnp, not Pallas, but every commit and every batched verify
// runs it.
//
// Digests are row-major (B, w, 8) 32-bit words, one digest a row, as the
// port's numpy digests come (read as uint32): a parent's message is its two
// children's 64 contiguous bytes, and a parent is 32 contiguous bytes.
//
// What bounds it on an H100: integer operations. A parent costs two
// compressions (about 2,300 32-bit instructions, 1,664 of them on the
// integer pipe) for 64 bytes read and 32 written.
//
// What the design does about that:
// - one launch a reduction. A block takes a unit of UNIT = 2^LOG_UNIT nodes
//   of one level of one tree (aligned: unit u holds nodes [u UNIT, (u + 1)
//   UNIT)), stages them in shared memory with coalesced 16-byte loads and
//   reduces them through up to SPAN levels there, one parent a thread,
//   with `__syncthreads` between levels. The unit's last level goes to
//   global memory. SPAN < LOG_UNIT keeps the narrow levels at a unit's top,
//   where few of the block's warps have work, few;
// - the 2^SPAN units of one level that feed one unit of the level SPAN
//   above meet by a ticket: each bumps an atomic counter after a fence,
//   and the last to arrive carries on with the unit above, so no block
//   ever waits on another (nothing can hang). A count past the number of
//   feeding units traps. The last block resets its counter, so every
//   counter is zero again when the launch ends and the next launch needs
//   no reset;
// - an odd level duplicates its last node by clamping the right child's
//   index; the unit that holds a level's last node also holds that node,
//   so no padded copy is made;
// - the second compression is the constant padding block of a 64-byte
//   message, whose K[t] + W[t] is the table kKW below (`_KW` in the
//   Python module): it computes no schedule;
// - every level is written to `out` when the caller keeps levels (proofs);
//   otherwise only the last level goes to `out`, and the levels where units
//   meet go to a scratch buffer of nodes. The tickets live in a buffer of
//   their own, so no launch's nodes land where another's counters are.
// UNIT and SPAN are the fastest in chip_probes.py's merkle_units sweep,
// which builds this file at other -D MERKLE_LOG_UNIT and MERKLE_SPAN.
#include "sha256_common.cuh"

#ifndef MERKLE_LOG_UNIT
#define MERKLE_LOG_UNIT 10
#endif
#ifndef MERKLE_SPAN
#define MERKLE_SPAN 6
#endif

namespace {

constexpr int LOG_UNIT = MERKLE_LOG_UNIT;
constexpr int UNIT = 1 << LOG_UNIT;   // nodes a unit takes in
constexpr int THREADS = UNIT / 2;     // one parent a thread at its first level
constexpr int SPAN = MERKLE_SPAN;     // levels a unit reduces
static_assert(THREADS >= 32 && THREADS <= 1024, "block size");
static_assert(SPAN >= 1 && SPAN <= LOG_UNIT, "levels a unit");

// K[t] + W[t] of the padding block [0x80000000, 0 x 14, 512].
static __constant__ uint32_t kKW[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u, 0x649b69c1u, 0xf0fe4786u,
    0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
    0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u, 0x007f3e86u, 0x37088980u,
    0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u,
    0x6ed41a95u, 0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

// The reduction's shape, the same on the host and the card: level l (0 is
// the leaves) has width ceil(n / 2^l); `levels` levels are reduced, the
// last the first at most `stop` wide.
struct Plan {
    int64_t B, n;
    int levels;

    __host__ __device__ int64_t width(int l) const { return ((n - 1) >> l) + 1; }
    __host__ __device__ int64_t units(int l) const {
        return ((width(l) - 1) >> LOG_UNIT) + 1;
    }
    // level l is where units meet (units of the level SPAN below end there
    // and units of it start), other than the last
    __host__ __device__ bool meets(int l) const {
        return l % SPAN == 0 && l > 0 && l < levels;
    }
    // words before level l in `out` when every level is kept
    __host__ __device__ int64_t kept_offset(int l) const {
        int64_t off = 0;
        for (int i = 1; i < l; ++i) off += B * 8 * width(i);
        return off;
    }
    // words before meeting level l in the scratch nodes
    __host__ __device__ int64_t meet_offset(int l) const {
        int64_t off = 0;
        for (int i = SPAN; i < l; i += SPAN) off += B * 8 * width(i);
        return off;
    }
    // counters before those of meeting level l (one a unit a tree)
    __host__ __device__ int64_t counter_offset(int l) const {
        int64_t off = 0;
        for (int i = SPAN; i < l; i += SPAN) off += B * units(i);
        return off;
    }
    __host__ __device__ int64_t counter_words() const {
        return counter_offset(levels);
    }
    __host__ __device__ int64_t node_words() const {
        return meet_offset(levels);
    }
};

__host__ __device__ inline int levels_for(int64_t n, int64_t stop) {
    int l = 0;
    while (((n - 1) >> l) + 1 > stop) ++l;
    return l;
}

// Where level l of tree b is stored, or null where it is not.
__device__ __forceinline__ uint32_t* level_at(const Plan& p, int l, int64_t b,
                                              int keep, uint32_t* out,
                                              uint32_t* nodes) {
    const int64_t row = b * 8 * p.width(l);
    if (keep) return out + p.kept_offset(l) + row;
    if (l == p.levels) return out + row;
    if (p.meets(l)) return nodes + p.meet_offset(l) + row;
    return nullptr;
}

__global__ void __launch_bounds__(THREADS)
merkle_reduce_kernel(const uint4* __restrict__ leaves, Plan p, int keep,
                     uint32_t* __restrict__ out,
                     unsigned int* __restrict__ counters,
                     uint32_t* __restrict__ nodes) {
    __shared__ uint4 stage[2 * UNIT];     // UNIT nodes, two 16-byte halves each
    __shared__ unsigned int carry_on;
    const int t = threadIdx.x;
    const int64_t units0 = p.units(0);
    const int64_t b = blockIdx.x / units0;
    int64_t u = blockIdx.x - b * units0;
    int level = 0;
    const uint4* src = leaves + b * 2 * p.n;
    for (;;) {
        // the unit's nodes of `level` into shared memory
        const int64_t lo = u << LOG_UNIT;
        const int64_t w = p.width(level);
        int count = (int)(w - lo < UNIT ? w - lo : UNIT);
        for (int i = t; i < 2 * count; i += THREADS)
            stage[i] = level == 0 ? __ldg(src + 2 * lo + i)
                                  : __ldcg(src + 2 * lo + i);
        __syncthreads();
        const int end = level + SPAN < p.levels ? level + SPAN : p.levels;
        for (int l = level + 1; l <= end; ++l) {
            const int parents = (count + 1) >> 1;
            uint32_t m[16];
            if (t < parents) {
                const int left = 2 * t;
                const int right = 2 * t + 1 < count ? 2 * t + 1 : count - 1;
                const uint4 x0 = stage[2 * left], x1 = stage[2 * left + 1];
                const uint4 y0 = stage[2 * right], y1 = stage[2 * right + 1];
                m[0] = x0.x; m[1] = x0.y; m[2] = x0.z; m[3] = x0.w;
                m[4] = x1.x; m[5] = x1.y; m[6] = x1.z; m[7] = x1.w;
                m[8] = y0.x; m[9] = y0.y; m[10] = y0.z; m[11] = y0.w;
                m[12] = y1.x; m[13] = y1.y; m[14] = y1.z; m[15] = y1.w;
            }
            __syncthreads();              // every child read before any write
            if (t < parents) {
                uint32_t st[8] = SHA256_H0;
                sha_compress(st, m);
                uint32_t a = st[0], bb = st[1], c = st[2], d = st[3];
                uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
                for (int r = 0; r < 64; ++r)
                    sha_round(a, bb, c, d, e, f, g, h, kKW[r]);
                const uint4 r0 = make_uint4(st[0] + a, st[1] + bb, st[2] + c,
                                            st[3] + d);
                const uint4 r1 = make_uint4(st[4] + e, st[5] + f, st[6] + g,
                                            st[7] + h);
                stage[2 * t] = r0;
                stage[2 * t + 1] = r1;
                uint32_t* dst = level_at(p, l, b, keep, out, nodes);
                if (dst) {
                    uint4* node = reinterpret_cast<uint4*>(
                        dst + 8 * ((lo >> (l - level)) + t));
                    node[0] = r0;
                    node[1] = r1;
                }
            }
            __syncthreads();
            count = parents;
        }
        if (end == p.levels) return;

        // units meet at level `end`: the last of the units under unit u >>
        // SPAN of `end` carries on with it
        __threadfence();                  // this unit's nodes before its ticket
        __syncthreads();
        const int64_t up = u >> SPAN;
        const int64_t feeding = p.units(level) - (up << SPAN);
        const unsigned int expect =
            (unsigned int)(feeding < (1 << SPAN) ? feeding : (1 << SPAN));
        if (t == 0) {
            unsigned int* ticket = counters + p.counter_offset(end)
                                   + b * p.units(end) + up;
            const unsigned int got = atomicAdd(ticket, 1u);
            if (got >= expect) __trap();  // a counter not zero at launch
            carry_on = got == expect - 1;
            if (carry_on) *ticket = 0;    // all `expect` units have arrived
        }
        __syncthreads();
        if (!carry_on) return;
        __threadfence();
        src = reinterpret_cast<const uint4*>(level_at(p, end, b, keep, out,
                                                      nodes));
        level = end;
        u = up;
    }
}

}  // namespace

// Words `pnp_merkle_reduce` needs for B trees of n leaves reduced to width
// <= stop: of counters (with `counters`), or of scratch nodes. The counters
// must be zero before the first launch that uses them; every launch leaves
// them zero. Launches that share them must be ordered (one stream).
extern "C" int64_t pnp_merkle_workspace_words(int64_t B, int64_t n,
                                              int64_t stop, int32_t counters) {
    if (B < 1 || n < 1 || stop < 1) return 0;
    const Plan p{B, n, levels_for(n, stop)};
    return counters ? p.counter_words() : p.node_words();
}

// leaves: (B, n, 8) words; out: levels 1 .. L as (B, w_l, 8) words one after
// the other with `keep`, else level L alone, where L is the first level at
// most `stop` wide (nothing is launched where n <= stop); counters and
// nodes as `pnp_merkle_workspace_words` sizes them. Launches one kernel on
// `stream`, on card `device` (-1: the current one), and returns
// cudaGetLastError().
extern "C" int pnp_merkle_reduce(const void* leaves, int64_t B, int64_t n,
                                 int64_t stop, int32_t keep, void* out,
                                 void* counters, void* nodes, int32_t device,
                                 void* stream) {
    if (B < 0 || n < 0 || stop < 1) return (int)cudaErrorInvalidValue;
    if (B == 0 || n <= stop) return 0;
    const Plan p{B, n, levels_for(n, stop)};
    const int64_t blocks = B * p.units(0);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    int prev = -1;
    if (device >= 0) {
        cudaError_t err = cudaGetDevice(&prev);
        if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
    }
    merkle_reduce_kernel<<<(unsigned int)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint4*)leaves, p, keep, (uint32_t*)out,
        (unsigned int*)counters, (uint32_t*)nodes);
    const int rc = (int)cudaGetLastError();
    if (prev >= 0 && prev != device) cudaSetDevice(prev);
    return rc;
}
