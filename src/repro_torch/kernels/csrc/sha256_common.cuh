// SHA-256 building blocks shared by sha256.cu and merkle.cu.
//
// Words are native uint32 here. The Python side keeps 32-bit words in int64
// tensors: sha256.cu reads their low halves itself, merkle.cu is handed
// int32 buffers, which C reads as uint32_t.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Round constants (FIPS 180-4 §4.2.2). Each translation unit gets its own
// copy: `static` keeps the host shadow symbols from clashing at link time.
static __constant__ uint32_t kSha256K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

#define SHA256_H0 {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au, \
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u}

__device__ __forceinline__ uint32_t sha_rotr(uint32_t x, int n) {
    return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t sha_bswap(uint32_t x) {
    return __byte_perm(x, 0, 0x0123);
}

// One round; `kw` is K[t] + W[t].
__device__ __forceinline__ void sha_round(uint32_t& a, uint32_t& b, uint32_t& c,
                                          uint32_t& d, uint32_t& e, uint32_t& f,
                                          uint32_t& g, uint32_t& h, uint32_t kw) {
    uint32_t s1 = sha_rotr(e, 6) ^ sha_rotr(e, 11) ^ sha_rotr(e, 25);
    uint32_t ch = g ^ (e & (f ^ g));
    uint32_t t1 = h + s1 + ch + kw;
    uint32_t s0 = sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22);
    uint32_t maj = (a & b) | (c & (a | b));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + s0 + maj;
}

// st <- compress(st, w). The 16-word schedule rolls in place in w, so after
// full unrolling every index is static and w stays in registers.
__device__ __forceinline__ void sha_compress(uint32_t st[8], uint32_t w[16]) {
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        if (t >= 16) {
            uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            uint32_t s0 = sha_rotr(w15, 7) ^ sha_rotr(w15, 18) ^ (w15 >> 3);
            uint32_t s1 = sha_rotr(w2, 17) ^ sha_rotr(w2, 19) ^ (w2 >> 10);
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;
        }
        sha_round(a, b, c, d, e, f, g, h, kSha256K[t] + w[t & 15]);
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}
