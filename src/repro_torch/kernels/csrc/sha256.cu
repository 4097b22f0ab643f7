// Batched SHA-256 over rows of big-endian 32-bit words.
//
// Replaces: src/repro/kernels/sha256.py `_sha256_kernel` / `sha256_pallas`
// (Pallas, TPU), together with the padding and batch-tiling that
// src/repro/kernels/ops.py `sha256_words` does around it.
//
// What bounds it on an H100: integer operations. One compression is about
// 1,400 32-bit instructions (three-input xors and adds fused into LOP3 and
// IADD3) on at most 64 bytes of message, at least 21 per byte read, while
// the card issues about 10 instructions per byte that 3.35 TB/s brings in.
//
// What the design does about that:
// - one thread per message, the 64 rounds fully unrolled, the 16-word
//   schedule rolling in registers and K in constant memory, so the rounds
//   touch no memory at all;
// - FIPS padding is made inside the kernel from W (word W is 0x80000000, the
//   last two words of the last block are the bit length), so no padded copy
//   of the batch is written and N needs no padding to a tile;
// - two optional outputs: the digest of the words as given (`raw`) and of
//   the words byte-swapped on load (`bswap`). The executor needs both for
//   every chunk (submission hash and Merkle leaf digest): one launch reads
//   each message once and runs the two compressions side by side.
// Rows stay row-major (N, W) as the executor builds them; a words-major
// layout would coalesce the loads and is later work.
#include "sha256_common.cuh"

template <bool RAW, bool BSWAP>
__global__ void sha256_rows_kernel(const uint32_t* __restrict__ msg, int64_t n,
                                   int w, int nb,
                                   uint32_t* __restrict__ out_raw,
                                   uint32_t* __restrict__ out_bswap) {
    int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t* row = msg + i * (int64_t)w;
    const uint64_t bits = (uint64_t)w * 32u;
    const int last = nb * 16 - 1;
    uint32_t sr[8] = SHA256_H0;
    uint32_t sb[8] = SHA256_H0;
    for (int blk = 0; blk < nb; ++blk) {
        uint32_t wr[16], wb[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            int g = blk * 16 + k;
            uint32_t x;
            if (g < w) {
                x = __ldg(row + g);
                wr[k] = x;
                wb[k] = sha_bswap(x);
                continue;
            }
            if (g == w) x = 0x80000000u;
            else if (g == last) x = (uint32_t)bits;
            else if (g == last - 1) x = (uint32_t)(bits >> 32);
            else x = 0u;
            wr[k] = x;
            wb[k] = x;
        }
        if (RAW) sha_compress(sr, wr);
        if (BSWAP) sha_compress(sb, wb);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        if (RAW) out_raw[i * 8 + k] = sr[k];
        if (BSWAP) out_bswap[i * 8 + k] = sb[k];
    }
}

// msg: (n, w) words; out_raw / out_bswap: (n, 8) words or null (not both).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int pnp_sha256_rows(const void* msg, int64_t n, int32_t w,
                               void* out_raw, void* out_bswap, void* stream) {
    if (w < 1 || n < 0 || (out_raw == nullptr && out_bswap == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const int64_t bits = (int64_t)w * 32;
    const int nb = (int)((bits + 1 + 64 + 511) / 512);
    const int threads = 128;
    const dim3 blocks((unsigned int)((n + threads - 1) / threads));
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* m = (const uint32_t*)msg;
    uint32_t* r = (uint32_t*)out_raw;
    uint32_t* b = (uint32_t*)out_bswap;
    if (r && b)
        sha256_rows_kernel<true, true><<<blocks, threads, 0, s>>>(m, n, w, nb, r, b);
    else if (r)
        sha256_rows_kernel<true, false><<<blocks, threads, 0, s>>>(m, n, w, nb, r, b);
    else
        sha256_rows_kernel<false, true><<<blocks, threads, 0, s>>>(m, n, w, nb, r, b);
    return (int)cudaGetLastError();
}
