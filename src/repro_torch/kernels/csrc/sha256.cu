// Batched SHA-256 over rows of big-endian 32-bit words.
//
// Replaces: src/repro/kernels/sha256.py `_sha256_kernel` / `sha256_pallas`
// (Pallas, TPU), together with the padding and batch-tiling that
// src/repro/kernels/ops.py `sha256_words` does around it.
//
// The words arrive as the port keeps them, int64 masked to 32 bits, and
// the digests leave as int64 words: the kernel reads the low half of each
// word and writes each digest word zero-extended, so a call is one launch
// with no conversion around it.
//
// What bounds it on an H100: integer operations. One compression is about
// 1,400 32-bit instructions (three-input xors and adds fused into LOP3 and
// IADD3, rotates as funnel shifts) on at most 128 bytes of int64 message,
// 11 a byte, while the card's integer pipe does ~5 in the time a byte
// arrives (1.67e13 against 3.35e12 a second). The rotates, LOP3 and IADD3
// issue to the SM's integer pipe, so its rate, not the whole issue rate,
// is the limit (chip_probes.py measures both).
//
// What the design does about that:
// - one thread a message in blocks of THREADS = 64 (the fastest at every
//   mining shape in chip_probes.py's sha256_blocks sweep, which builds this
//   file at other -D SHA_THREADS), the 64 rounds fully unrolled, the
//   16-word schedule rolling in registers and K in constant memory, so the
//   rounds touch no memory;
// - FIPS padding is made in registers from W (word W is 0x80000000, the
//   last two words of the last block are the bit length), so no padded copy
//   of the batch is written and N needs no padding to a tile; at the mining
//   path's widths, W = 2 and 8, W is a compile-time constant, so the padding
//   words fold into the message schedule (SHA_FIXED_W=0 drops those
//   instances, for the sweep);
// - a block stages each 64-byte message block of its rows through shared
//   memory with 16-byte loads of the row-major (N, W) input, consecutive
//   threads on consecutive addresses (8-byte loads where rows are not whole
//   16-byte pieces), and writes its digests back the same way: every load
//   and store is coalesced at any W, with no transpose;
// - two optional outputs: the digest of the words as given (`raw`) and of
//   the words byte-swapped on load (`bswap`). The executor needs both for
//   every chunk (submission hash and Merkle leaf digest): one launch reads
//   each message once and runs the two compressions side by side, two
//   independent instruction streams a thread.
#include "sha256_common.cuh"

#ifndef SHA_THREADS
#define SHA_THREADS 64
#endif
#ifndef SHA_FIXED_W
#define SHA_FIXED_W 1
#endif

namespace {

constexpr int THREADS = SHA_THREADS;   // a block, one row a thread
static_assert(THREADS % 32 == 0 && THREADS <= 512, "block size");
// words a staged row takes in shared memory: 16 and one of padding, odd,
// so the 32 lanes reading one column of their rows hit 32 banks
constexpr int STRIDE = 17;

// Digest state words of `nrows` staged rows back to the (n, 8) int64
// output, 16 bytes a thread and store, consecutive threads on consecutive
// addresses.
__device__ __forceinline__ void store_digests(const uint32_t* stage,
                                              int nrows, int64_t row0,
                                              int64_t* __restrict__ out) {
    longlong2* dst = reinterpret_cast<longlong2*>(out + row0 * 8);
    for (int p = threadIdx.x; p < nrows * 4; p += THREADS) {
        const uint32_t* s = stage + (p >> 2) * STRIDE + 2 * (p & 3);
        dst[p] = make_longlong2((long long)s[0], (long long)s[1]);
    }
}

// A thread's digest state into its staged row, then the block's rows out.
__device__ __forceinline__ void write_digests(uint32_t* stage,
                                              const uint32_t* st, int nrows,
                                              int64_t row0,
                                              int64_t* __restrict__ out) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 8; ++k) stage[threadIdx.x * STRIDE + k] = st[k];
    __syncthreads();
    store_digests(stage, nrows, row0, out);
}

// Message blocks of a W-word message: its bits, the 0x80 byte and the
// 64-bit length, in 512-bit blocks.
__host__ __device__ constexpr int blocks_for(int w) {
    return (w * 32 + 1 + 64 + 511) / 512;
}

// WC > 0 fixes W at compile time (the path's widths), so the padding words
// are constants and the compiler folds them into the message schedule.
template <bool RAW, bool BSWAP, int WC>
__global__ void __launch_bounds__(THREADS)
sha256_rows_kernel(const int64_t* __restrict__ msg, int64_t n, int w_arg,
                   int vec, int64_t* __restrict__ out_raw,
                   int64_t* __restrict__ out_bswap) {
    __shared__ uint32_t stage[THREADS * STRIDE];
    const int w = WC ? WC : w_arg;
    const int nb = blocks_for(w);
    const int64_t row0 = (int64_t)blockIdx.x * THREADS;
    const int nrows = (int)(n - row0 < THREADS ? n - row0 : THREADS);
    const int64_t* src = msg + row0 * w;
    const uint64_t bits = (uint64_t)w * 32u;
    const int last = nb * 16 - 1;
    uint32_t sr[8] = SHA256_H0;
    uint32_t sb[8] = SHA256_H0;
    for (int blk = 0; blk < nb; ++blk) {
        const int g0 = blk * 16;
        const int cw = w - g0 < 16 ? w - g0 : 16;   // words from memory
        if (cw > 0) {
            if (blk) __syncthreads();
            if (vec) {   // w even: every row's words g0.. start 16-aligned
                const int per_row = cw >> 1;
                for (int p = threadIdx.x; p < nrows * per_row; p += THREADS) {
                    const int r = p / per_row, q = p - r * per_row;
                    const longlong2 v = __ldg(
                        reinterpret_cast<const longlong2*>(
                            src + (int64_t)r * w + g0) + q);
                    stage[r * STRIDE + 2 * q] = (uint32_t)v.x;
                    stage[r * STRIDE + 2 * q + 1] = (uint32_t)v.y;
                }
            } else {
                for (int p = threadIdx.x; p < nrows * cw; p += THREADS) {
                    const int r = p / cw, q = p - r * cw;
                    stage[r * STRIDE + q] =
                        (uint32_t)__ldg(src + (int64_t)r * w + g0 + q);
                }
            }
            __syncthreads();
        }
        // rows beyond nrows read stale words and are never stored
        const uint32_t* row = stage + threadIdx.x * STRIDE;
        uint32_t wr[16], wb[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const int g = g0 + k;
            if (k < cw) {
                const uint32_t x = row[k];
                wr[k] = x;
                wb[k] = sha_bswap(x);
            } else {
                const uint32_t x = g == w ? 0x80000000u
                    : g == last ? (uint32_t)bits
                    : g == last - 1 ? (uint32_t)(bits >> 32) : 0u;
                wr[k] = x;
                wb[k] = x;
            }
        }
        if (RAW) sha_compress(sr, wr);
        if (BSWAP) sha_compress(sb, wb);
    }
    if (RAW) write_digests(stage, sr, nrows, row0, out_raw);
    if (BSWAP) write_digests(stage, sb, nrows, row0, out_bswap);
}

template <int WC>
int launch(const int64_t* m, int64_t n, int w, int64_t* r, int64_t* b,
           cudaStream_t s) {
    const int vec = (w % 2 == 0) && ((uintptr_t)m % 16 == 0);
    const int64_t blocks = (n + THREADS - 1) / THREADS;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    const unsigned g = (unsigned)blocks;
    if (r && b)
        sha256_rows_kernel<true, true, WC><<<g, THREADS, 0, s>>>(
            m, n, w, vec, r, b);
    else if (r)
        sha256_rows_kernel<true, false, WC><<<g, THREADS, 0, s>>>(
            m, n, w, vec, r, b);
    else
        sha256_rows_kernel<false, true, WC><<<g, THREADS, 0, s>>>(
            m, n, w, vec, r, b);
    return (int)cudaGetLastError();
}

}  // namespace

// msg: (n, w) int64 words (low 32 bits read); out_raw / out_bswap: (n, 8)
// int64 words or null (not both), 16-byte aligned. Launches on `stream` of
// card `device` (made current for the launch, then restored) and returns
// cudaGetLastError().
extern "C" int pnp_sha256_rows(const void* msg, int64_t n, int32_t w,
                               void* out_raw, void* out_bswap, int32_t device,
                               void* stream) {
    if (w < 1 || n < 0 || (out_raw == nullptr && out_bswap == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const int64_t* m = (const int64_t*)msg;
    int64_t* r = (int64_t*)out_raw;
    int64_t* b = (int64_t*)out_bswap;
    int prev = -1;
    if (device >= 0) {
        cudaError_t err = cudaGetDevice(&prev);
        if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
    }
    cudaStream_t s = (cudaStream_t)stream;
    int rc;
    if (SHA_FIXED_W && w == 2) rc = launch<2>(m, n, w, r, b, s);
    else if (SHA_FIXED_W && w == 8) rc = launch<8>(m, n, w, r, b, s);
    else rc = launch<0>(m, n, w, r, b, s);
    if (prev >= 0 && prev != device) cudaSetDevice(prev);
    return rc;
}
