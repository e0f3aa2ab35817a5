// The int8 wgmma kernels' common parts (flash_int8_wgmma.cu, the
// SageAttention kernel with per-block scales, and flash_int8_uniform_wgmma.cu,
// its one-scale precursor): the tiles, the exact int32 -> fp32 conversion,
// the rounding of P * 127 without F2I, P packed into the A fragments of P.V,
// and the wgmma issue of Q.K^T and P.V. See flash_int8_wgmma.cu for the
// design they serve.

#pragma once

#include "hopper.cuh"

namespace int8_wgmma {

using namespace hopper;

constexpr int D = 64;
constexpr int BM = 128;             // query rows per block: 2 consumer warpgroups x 64
constexpr int BN = 128;             // keys per streamed tile
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;       // producer warpgroup + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int Q_BYTES = BM * D;     // int8
constexpr int K_BYTES = BN * D;     // int8
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <bool PV>
struct Tile {
  static constexpr int V_BYTES = PV ? D * BN : BN * D * 2;   // int8 V^T or bf16 V
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  static constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + 8 * (1 + 3 * STAGES);
};

// an int32 (|s| < 2^22) as fp32, exactly, without I2F
__device__ __forceinline__ float s32_to_f32(uint32_t s) {
  return __int_as_float(static_cast<int>(s + 0x4B400000u)) - 12582912.f;
}

// round(p * 127) of four probabilities in [0, 1] (half to even) as 4 int8,
// without F2I: the low byte of p * 127 + 1.5 * 2^23
__device__ __forceinline__ uint32_t pack_p8(float p0, float p1, float p2, float p3) {
  const uint32_t a = __float_as_uint(fmaf(p0, 127.f, 12582912.f));
  const uint32_t b = __float_as_uint(fmaf(p1, 127.f, 12582912.f));
  const uint32_t c = __float_as_uint(fmaf(p2, 127.f, 12582912.f));
  const uint32_t d = __float_as_uint(fmaf(p3, 127.f, 12582912.f));
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The lazy softmax's bound on a thread's row sums: a tile whose sums stay
// within it keeps the running max; one past it (a row's max grew by more
// than about log2(LAZY_LIMIT), or p overflowed) takes the exact softmax.
constexpr float LAZY_LIMIT = 4096.f;

// P as the A fragments of P.V. bf16 (8 k-steps of 16 keys): the m16n8k16 A
// layout is S's accumulator layout, two 8-key chunks per step. int8 (4
// k-steps of 32 keys): register r of step kk holds positions 4t .. 4t + 3 of
// the step's 16-key group r >> 1 for row g + 8 (r & 1), i.e. keys 2t, 2t + 1
// of its first chunk and 2t, 2t + 1 of its second (the permuted V^T).
template <bool PV>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[PV ? 4 : 8][4], const uint32_t (&s)[64]) {
  auto f = [&](int i) { return __uint_as_float(s[i]); };
  if constexpr (PV) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 16 * kk + 8 * (r >> 1) + 2 * (r & 1);
        pa[kk][r] = pack_p8(f(i), f(i + 1), f(i + 4), f(i + 5));
      }
  } else {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(f(8 * kk + 0), f(8 * kk + 1));
      pa[kk][1] = pack_bf16(f(8 * kk + 2), f(8 * kk + 3));
      pa[kk][2] = pack_bf16(f(8 * kk + 4), f(8 * kk + 5));
      pa[kk][3] = pack_bf16(f(8 * kk + 6), f(8 * kk + 7));
    }
  }
}

// Descriptors are built once, for stage 0; a stage or a k-step adds its byte
// offset / 16 to the start-address field (shared memory spans less than
// 2^18 bytes, so the 14-bit field never carries into the next one).

__device__ __forceinline__ void issue_qk(uint32_t (&s)[64], uint64_t qdesc, uint64_t kdesc) {
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    wgmma_ss_m64n128_s8(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
}

// bf16: O += P V, V [128 keys x 64] read MN-major (a k-step of 16 keys is 2048 bytes)
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[8][4],
                                         uint64_t vdesc) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_m64n64_tb(o, pa[kk], vdesc + kk * (2048 >> 4));
}

// int8: acc = P8 V8 (s32), V^T [64 x 128 permuted keys] K-major (a k-step is 32 bytes)
__device__ __forceinline__ void issue_pv8(uint32_t (&acc)[32], const uint32_t (&pa)[4][4],
                                          uint64_t vdesc) {
#pragma unroll
  for (int kk = 0; kk < BN / 32; ++kk) wgmma_rs_m64n64_s8(acc, pa[kk], vdesc + 2 * kk, kk);
}

}  // namespace int8_wgmma
