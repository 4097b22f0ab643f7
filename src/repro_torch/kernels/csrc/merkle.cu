// One level of a Merkle tree (or of B same-width trees): SHA-256 of each
// pair of child digests.
//
// Replaces: src/repro/kernels/merkle.py `_node_hash`, traced under
// `_tree_fn` (one tree) and `_forest_fn` (B trees). The JAX package writes
// it as jitted jnp, not Pallas, but every commit and every batched verify
// runs it.
//
// What bounds it on an H100: integer operations. A parent costs two
// compressions (about 2,300 32-bit instructions) for 64 bytes read and 32
// written, some 24 per byte moved against the card's 10.
//
// What the design does about that:
// - one thread per parent node on the words-major (8, B, w) layout of the
//   reference: each thread reads word k of its two children from row k, so
//   neighbouring threads read neighbouring pairs of a row;
// - block 1 (the 16 child words) keeps its schedule in registers; block 2
//   is the constant padding block of a 64-byte message, whose K[t] + W[t]
//   is the precomputed table kKW below (`_KW` in the Python module), so the
//   second compression computes no schedule at all;
// - an odd level duplicates its last child by clamping the right child's
//   index, with no padded copy of the level;
// - one launch per level; the host loop stops at the reference's cutover
//   width and hashlib finishes the narrow top. One persistent launch for
//   all levels is later work.
#include "sha256_common.cuh"

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

__global__ void merkle_level_kernel(const uint32_t* __restrict__ in, int64_t B,
                                    int64_t w, uint32_t* __restrict__ out) {
    const int64_t half = (w + 1) / 2;
    const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (i >= B * half) return;
    const int64_t b = i / half, j = i - b * half;
    const int64_t left = 2 * j;
    const int64_t right = (2 * j + 1 < w) ? 2 * j + 1 : w - 1;
    const int64_t plane = B * w;
    const uint32_t* row = in + b * w;
    uint32_t m[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        m[k] = __ldg(row + k * plane + left);
        m[8 + k] = __ldg(row + k * plane + right);
    }
    uint32_t st[8] = SHA256_H0;
    sha_compress(st, m);
    uint32_t a = st[0], bb = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) sha_round(a, bb, c, d, e, f, g, h, kKW[t]);
    const uint32_t res[8] = {st[0] + a, st[1] + bb, st[2] + c, st[3] + d,
                             st[4] + e, st[5] + f, st[6] + g, st[7] + h};
    const int64_t oplane = B * half;
    uint32_t* dst = out + b * half + j;
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[k * oplane] = res[k];
}

// in: (8, B, w) words; out: (8, B, ceil(w / 2)) words.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int pnp_merkle_level(const void* in, int64_t B, int64_t w, void* out,
                                void* stream) {
    if (B < 0 || w < 1) return (int)cudaErrorInvalidValue;
    const int64_t parents = B * ((w + 1) / 2);
    if (parents == 0) return 0;
    const int threads = 128;
    const dim3 blocks((unsigned int)((parents + threads - 1) / threads));
    merkle_level_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, B, w, (uint32_t*)out);
    return (int)cudaGetLastError();
}
