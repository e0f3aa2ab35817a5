// int8 flash-attention forward with ONE dequantization scale, for Hopper
// (sm_90a): warp-specialised, fed by TMA through an mbarrier ring, Q.K^T on
// the int8 tensor cores with wgmma (s8 x s8 -> s32), P.V on wgmma in bf16 or
// int8.
//
// Replaces tools/bench_int8_attn.py::_int8_kernel (launched by _int8_flash),
// the precursor of the SageAttention-style kernel. Same entry point, function
// and numerics as the mma.sync kernel it supersedes
// (vp_flash_int8_uniform_fwd in flash_int8_fwd.cu, kept as a yardstick):
// int8 Q . int8 K^T with int32 accumulation, every score dequantized by the
// one factor sm_scale * deq_scale (formed in fp32), the plain key mask
// `col < kv_len`, an online softmax with fp32 running max, denominator and
// accumulator, then either P (rounded to bf16) . V (bf16) with fp32
// accumulation, or in the int8 P.V mode round(P * 127) as int8 times int8 V
// with int32 accumulation, the sum divided by 127; bf16 output. In the int8
// P.V mode P is rounded against the running max of each 128-key tile (the
// TPU kernel and the plain version: each blk_k block), so the rounded P may
// differ there in its last bit.
//
// The design is flash_int8_wgmma.cu's (the SageAttention kernel, with
// per-block scales), which this function is a special case of: a producer
// warpgroup and 2 consumer warpgroups of 64 query rows, 128-key tiles in a
// 4-stage TMA ring, S on wgmma m64n128k32 s8 over 64-byte-swizzled tiles, bf16
// P.V on register-A wgmma m64n64k16 with S_{j+1} in flight beside P_j V_j and
// the two consumer warpgroups taking turns (ping-pong), int8 P.V on
// register-A wgmma m64n64k32 s8 against the PERM16-permuted V^T in two turns
// a tile, P rounded without F2I. What one scale for every score changes:
//  - no scale tables and no k-block count in the key loop: the factor
//    f = sm_scale * deq_scale * log2(e) is a kernel argument;
//  - the int32 -> fp32 conversion folds into the softmax's FMA. Every score
//    has |s| <= 64 * 127^2 = 1,032,256 < 2^22, so x = s + 1.5 * 2^23 is exact
//    as the float __int_as_float(s + 0x4B400000) (one integer add). The
//    running max M is kept in the shifted domain (a float, the product of the
//    largest x by f rounded up) and p = exp2(fmaf(x, f, -M)). The shift
//    1.5 * 2^23 * f is the same for every score of the launch, so it is a
//    per-row constant, as is any rounding of M, and softmax is
//    shift-invariant: alpha = exp2(M_old - M_new) uses the same floats, so
//    both cancel in O / l. What remains is the FMA's one rounding of its small
//    result and the rounding of f that every version pays. M rounded up keeps
//    fmaf(x, f, -M) <= 0 for every x of the row, so P <= 1 where the int8 P.V
//    mode needs it. A score takes 4 instructions (integer add, FMA, exp2,
//    sum) where flash_int8_wgmma.cu takes 5: its per-block scales change the
//    shift from k-block to k-block, which would not cancel;
//  - the bf16 P.V mode skips the max pass on a tile without a masked key, as
//    flash_int8_wgmma.cu does: p = exp2(fmaf(x, f, -M)) against the running
//    max as it stands, the row sums checked (at most LAZY_LIMIT) and voted on
//    by the warpgroup with bar.red.or; a failed vote issues S again and takes
//    the exact softmax. The int8 P.V mode keeps the max pass on every tile:
//    its round(P * 127) needs P <= 1, so a tile could skip the pass only where
//    no row of the 64 gains a new max, and with thousands of keys that fails
//    on most early tiles, each failure costing S again;
//  - the int8 P.V mode's 1 / 127 moves into the epilogue (O / (127 l)).

#include "hopper.cuh"
#include "int8_wgmma.cuh"

namespace {

using namespace hopper;
using namespace int8_wgmma;

constexpr uint32_t SHIFT = 0x4B400000u;   // the bits of 1.5 * 2^23, whose ulp is 1

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  int H, S_q, kv_len;
  float f;              // sm_scale * deq_scale * log2(e)
};

// a score s (|s| < 2^22) as the float s + 1.5 * 2^23, exactly, without I2F
__device__ __forceinline__ float shifted(uint32_t s) {
  return __int_as_float(static_cast<int>(s + SHIFT));
}

// int32 scores of one key tile into probabilities (fp32 bits, in place), the
// running max (shifted domain, times f) and denominator updated, alpha = the
// factor that rescales O. Rows g and g + 8 of the warp: accumulator registers
// i with (i >> 1) & 1 = 0, 1; register i holds key n0 + 8 (i >> 2) + 2t + (i & 1).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(uint32_t (&s)[64], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], float f,
                                             int kv_len, int n0, int t) {
  float r[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = shifted(s[i]);
    if (MASK && n0 + 8 * (i >> 2) + 2 * t + (i & 1) >= kv_len) x = -INFINITY;
    s[i] = __float_as_uint(x);
    r[(i >> 1) & 1] = fmaxf(r[(i >> 1) & 1], x);
  }
  float mx[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    // max(x) * f = max(x * f) for f > 0; rounded up, so no x f of the row exceeds it
    mx[q] = fmaxf(m_run[q], __fmul_ru(r[q], f));
    mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], 1));
    mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], 2));
    alpha[q] = ex2(m_run[q] - mx[q]);
    m_run[q] = mx[q];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int q = (i >> 1) & 1;
    const float pe = ex2(fmaf(__uint_as_float(s[i]), f, -mx[q]));   // masked: exp2(-inf) = 0
    s[i] = __float_as_uint(pe);
    sum[q] += pe;
  }
  l_run[0] = l_run[0] * alpha[0] + sum[0];
  l_run[1] = l_run[1] * alpha[1] + sum[1];
}

// The softmax of a tile without a masked key against the running max as it
// stands, p = exp2(x f - M), with no max pass (flash_int8_wgmma.cu's): the
// caller commits the row sums (alpha stays 1) when every thread's are at most
// LAZY_LIMIT, and otherwise computes S again and takes softmax_tile.
__device__ __forceinline__ bool softmax_lazy(uint32_t (&s)[64], const float (&m_run)[2],
                                             float (&sum)[2], float f) {
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int q = (i >> 1) & 1;
    const float pe = ex2(fmaf(shifted(s[i]), f, -m_run[q]));
    s[i] = __float_as_uint(pe);
    sum[q] += pe;
  }
  return sum[0] <= LAZY_LIMIT && sum[1] <= LAZY_LIMIT;   // false for inf and NaN too
}

__device__ __forceinline__ void softmax_any(uint32_t (&s)[64], float (&m_run)[2],
                                            float (&l_run)[2], float (&alpha)[2], float f,
                                            int kv_len, int n0, int t) {
  if (n0 + BN > kv_len)
    softmax_tile<true>(s, m_run, l_run, alpha, f, kv_len, n0, t);
  else
    softmax_tile<false>(s, m_run, l_run, alpha, f, kv_len, n0, t);
}

template <bool PV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_int8_uniform_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int V_BYTES = Tile<PV>::V_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  const uint32_t sq = base;
  const uint32_t sk = sq + Q_BYTES;
  const uint32_t sv = sk + STAGES * K_BYTES;
  const uint32_t bars = base + Tile<PV>::BAR_OFFSET;
  const uint32_t bar_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int m0 = blockIdx.x * BM;
  // keys past kv_len contribute exp2(-inf) = 0; the loop stops at the last valid one
  const int n_tiles = (p.kv_len + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_q, Q_BYTES);
      tma_load_4d(sq, &tq, bar_q, 0, m0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);   // the first round passes at once
        mbar_arrive_expect_tx(full_k(s), K_BYTES);
        tma_load_4d(sk + s * K_BYTES, &tk, full_k(s), 0, j * BN, h, b);
        mbar_arrive_expect_tx(full_v(s), V_BYTES);
        if (PV)   // V^T: (keys, d rows)
          tma_load_4d(sv + s * V_BYTES, &tv, full_v(s), j * BN, 0, h, b);
        else
          tma_load_4d(sv + s * V_BYTES, &tv, full_v(s), 0, j * BN, h, b);
      }
    }
  } else {
    // ---- consumers: warpgroup w owns query rows m0 + 64 w .. + 63 ----
    regs_inc<CONSUMER_REGS>();
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // ping-pong: warpgroup w waits on barrier 1 + w before issuing its
    // products and then lets the other one go; the last hand-over of
    // warpgroup 1 would have no taker and is left out
    const int my_bar = 1 + w, other_bar = 2 - w;
    if (w == 1) bar_arrive(other_bar, 256);
    auto hand_over = [&](bool last) {
      if (w == 0 || !last) bar_arrive(other_bar, 256);
    };

    const float f = p.f;
    const uint64_t qdesc = desc_sw64(sq + w * 64 * D, 16, 512);
    const uint64_t kdesc0 = desc_sw64(sk, 16, 512);
    const uint64_t vdesc0 = PV ? desc_sw128(sv, 16, 1024) : desc_sw128(sv, 1024, 1024);
    auto kdesc = [&](int stage) { return kdesc0 + stage * (K_BYTES >> 4); };
    auto vdesc = [&](int stage) { return vdesc0 + stage * (V_BYTES >> 4); };
    uint32_t s[64];
    float o[32];
    uint32_t pa[PV ? 4 : 8][4];
    float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // O *= alpha, skipped when no row of the warp has a new max
    auto rescale = [&]() {
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
    };
    mbar_wait(bar_q, 0);

    if constexpr (!PV) {
      // bf16 P.V: S_{j+1} is issued with P_j V_j and its softmax runs while
      // P_j V_j is in flight
      mbar_wait(full_k(0), 0);
      bar_sync(my_bar, 256);
      wgmma_fence();
      issue_qk(s, qdesc, kdesc(0));
      wgmma_commit();
      hand_over(n_tiles == 1);
      wgmma_wait<0>();
      keep(s);
      softmax_any(s, m_run, l_run, alpha, f, p.kv_len, 0, t);
      pack_p<PV>(pa, s);
      for (int j = 1; j < n_tiles; ++j) {
        const int st = j % STAGES, pst = (j - 1) % STAGES;
        mbar_wait(full_k(st), (j / STAGES) & 1);
        bar_sync(my_bar, 256);
        wgmma_fence();
        issue_qk(s, qdesc, kdesc(st));                   // S_j
        wgmma_commit();
        rescale();
        mbar_wait(full_v(pst), ((j - 1) / STAGES) & 1);
        wgmma_fence();
        issue_pv(o, pa, vdesc(pst));                     // O += P_{j-1} V_{j-1}
        wgmma_commit();
        hand_over(j == n_tiles - 1);
        wgmma_wait<1>();                                 // S_j done; P V in flight
        keep(s);
        // tiles without a masked key first try the running max as it stands;
        // the warpgroup decides together, since S is issued again by all
        bool exact = (j + 1) * BN > p.kv_len;
        if (!exact) {
          float sum[2];
          exact = bar_any(!softmax_lazy(s, m_run, sum, f), 3 + w, 128);
          if (!exact) {
            l_run[0] += sum[0];
            l_run[1] += sum[1];
            alpha[0] = alpha[1] = 1.f;
          } else {
            wgmma_fence();
            issue_qk(s, qdesc, kdesc(st));
            wgmma_commit();
            wgmma_wait<0>();
            keep(s);
          }
        }
        if (exact) softmax_any(s, m_run, l_run, alpha, f, p.kv_len, j * BN, t);
        wgmma_wait<0>();
        keep(o);
        keep(pa);
        mbar_arrive(empty(pst));
        pack_p<PV>(pa, s);
      }
      const int lst = (n_tiles - 1) % STAGES;
      rescale();
      mbar_wait(full_v(lst), ((n_tiles - 1) / STAGES) & 1);
      wgmma_fence();
      issue_pv(o, pa, vdesc(lst));
      wgmma_commit();
      wgmma_wait<0>();
      keep(o);
      keep(pa);
    } else {
      // int8 P.V: two turns a tile (S, then P V), the max pass on every tile
      uint32_t acc[32];
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        mbar_wait(full_k(st), (j / STAGES) & 1);
        bar_sync(my_bar, 256);
        wgmma_fence();
        issue_qk(s, qdesc, kdesc(st));
        wgmma_commit();
        hand_over(false);
        wgmma_wait<0>();
        keep(s);
        softmax_any(s, m_run, l_run, alpha, f, p.kv_len, j * BN, t);
        rescale();
        pack_p<PV>(pa, s);
        mbar_wait(full_v(st), (j / STAGES) & 1);
        bar_sync(my_bar, 256);
        wgmma_fence();
        issue_pv8(acc, pa, vdesc(st));
        wgmma_commit();
        hand_over(j == n_tiles - 1);
        wgmma_wait<0>();
        keep(acc);
        keep(pa);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] += s32_to_f32(acc[i]);
        mbar_arrive(empty(st));
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const int r0 = m0 + w * 64 + warp * 16 + g, r1 = r0 + 8;
    // the int8 P.V mode's 1 / 127 joins the division by the row sum
    const float inv0 = 1.f / (PV ? 127.f * l_run[0] : l_run[0]);
    const float inv1 = 1.f / (PV ? 127.f * l_run[1] : l_run[1]);
    __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (r0 < p.S_q)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * p.o_ss + col) =
            __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (r1 < p.S_q)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * p.o_ss + col) =
            __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

template <bool PV>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int B, cudaStream_t stream) {
  int rc = check_registers(flash_int8_uniform_kernel<PV>, NTHREADS, 128, PRODUCER_REGS,
                           CONSUMER_REGS);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_int8_uniform_kernel<PV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<PV>::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S_q + BM - 1) / BM, B * p.H);
  flash_int8_uniform_kernel<PV><<<grid, NTHREADS, Tile<PV>::SMEM_BYTES, stream>>>(tq, tk, tv,
                                                                                  p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k: int8 [B, H, S, 64] addressed by element strides (last dim contiguous,
// every stride a multiple of 16, 16-byte aligned bases). v: bf16
// [B, H, S_k, 64] (strides multiples of 8), or with int8_pv the transposed
// int8 V^T [B, H, 64, S_k padded with zeros to a multiple of 128] whose key
// columns are permuted within each 16-key group (position 4t + i holds key
// 2t + i for i < 2, 8 + 2t + i - 2 for i >= 2; v_ss = the row stride of V^T).
// o: bf16 [B, H, S_q, 64] by strides. Every score is scaled by
// sm_scale * deq_scale; keys at kv_len and past it are masked (1 <= kv_len <= S_k).
// Returns the cudaError_t of the launch, or a negative hopper::ERR_* code.
extern "C" int vp_flash_int8_uniform_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int H, int S_q, int S_k,
                                         long long q_sb, long long q_sh, long long q_ss,
                                         long long k_sb, long long k_sh, long long k_ss,
                                         long long v_sb, long long v_sh, long long v_ss,
                                         long long o_sb, long long o_sh, long long o_ss,
                                         float sm_scale, float deq_scale, int kv_len,
                                         int int8_pv, void* stream) {
  if (kv_len < 1 || kv_len > S_k) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int rc = make_map_t(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, B, H, S_q, q_sb, q_sh, q_ss,
                      D, BM, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc == 0)
    rc = make_map_t(&tk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, B, H, S_k, k_sb, k_sh, k_ss,
                    D, BN, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc == 0) {
    // V^T's extent is the padded one: the permutation moves keys of the last
    // 16-key group to positions past S_k
    const int padded = (S_k + BN - 1) / BN * BN;
    rc = int8_pv ? make_map_t(&tv, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, padded, B, H, D, v_sb,
                              v_sh, v_ss, BN, D, CU_TENSOR_MAP_SWIZZLE_128B)
                 : make_map(&tv, v, B, H, S_k, v_sb, v_sh, v_ss, BN);
  }
  if (rc != 0) return rc;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.H = H; p.S_q = S_q; p.kv_len = kv_len;
  p.f = (sm_scale * deq_scale) * LOG2E;   // the scale product in fp32, as the TPU kernel forms it
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int8_pv ? launch<true>(tq, tk, tv, p, B, st) : launch<false>(tq, tk, tv, p, B, st);
}
