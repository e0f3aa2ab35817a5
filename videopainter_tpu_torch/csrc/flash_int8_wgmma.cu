// int8 (SageAttention-style) flash-attention forward for Hopper (sm_90a):
// warp-specialised, fed by TMA through an mbarrier ring, Q.K^T on the int8
// tensor cores with wgmma (s8 x s8 -> s32), P.V on wgmma in bf16 or int8.
//
// Replaces videopainter_tpu/ops/flash_attention_int8.py::_int8_flash_kernel
// (launched by _int8_flash_padded). Same entry point, function and numerics
// as the mma.sync kernel it supersedes (vp_flash_int8_fwd in
// flash_int8_fwd.cu, kept as a yardstick): int8 Q . int8 K^T with int32
// accumulation, the
// scores converted to fp32 and dequantized once by
// sm_scale * sq[q-block] * sk[k-block] (the scale product formed in fp32
// first), the key mask (plain `col < kv_len`, paged
// `(col < S_k) && (col % kv_page < kv_len)`, masked scores the finite
// -1e30), an online softmax with fp32 running max, denominator and
// accumulator, then either P (rounded to bf16) . V (bf16) with fp32
// accumulation, or in the int8 P.V mode round(P * 127) as int8 times int8 V
// with int32 accumulation scaled by sv[k-block] / 127; bf16 output. The
// kernel's tiles (128 query rows, 128 keys) must divide the quantization
// blocks blk_q / blk_k, so one sq holds per block and one sk / sv per key
// tile. In the int8 P.V mode P is rounded against the running max of each
// 128-key tile (the mma.sync kernel: each 64-key tile; the TPU kernel and
// the plain version: each blk_k block), so the rounded P may differ there in
// its last bit.
//
// What bounds it on the H100. At the DiT's ID-resample call (B*H = 96,
// 17,776 queries, 35,552 keys, d = 64) Q.K^T is 7.8 TOP (3.9 ms at the
// 1,979 TOP/s dense int8 peak) and P.V 7.8 TFLOP in bf16 (7.9 ms at
// 989 TFLOP/s), 11.8 ms together (7.9 ms with int8 P.V), against 0.3 GB of
// operands. The softmax's 6.07e10 exponentials at 16 per SM per clock
// (132 SMs, 1.98 GHz) take 14.5 ms on their own, and the mma.sync kernel
// paid that unit twice more per score: an I2F for each int32 score and, in
// the int8 P.V mode, an F2I for each probability. So the design is
// flash_fwd_wgmma.cu's, with neither conversion:
//  - one block per (128 query rows, b*h): warpgroup 0 is the producer, 1 and
//    2 the consumers, 64 query rows each, one block per SM; setmaxnreg
//    40 / 232 (ptxas still compiles within the launch's 168 registers: a
//    build with 3 consumer warpgroups compiled within 128 and spilled);
//  - one producer thread issues every load: int8 Q once, then int8 K tiles of
//    128 keys into a 4-stage ring, with V's tiles beside them: in the bf16
//    mode V's bf16 tiles on flash_fwd_wgmma.cu's map, in the int8 P.V mode
//    int8 V^T tiles of 64 rows x 128 keys. Each stage has a full barrier per
//    operand (TMA byte count) and an empty barrier (the consumer threads).
//    TMA zero-fills rows past S_q / S_k: keys there are masked, query rows
//    are not stored;
//  - shared layouts: an int8 row of d = 64 is 64 bytes, so Q and K take the
//    64-byte swizzle (atoms of 8 rows x 64 bytes, stride byte offset 512,
//    descriptor layout type 2, 2 k-steps of 32 bytes over d); a V^T row of
//    128 keys is 128 bytes and takes the 128-byte swizzle (K-major, stride
//    byte offset 1024, 4 k-steps of 32 keys). CUtensorMapDataType has no
//    signed 8-bit type: the maps are UINT8, whose zero fill is still zero;
//  - S = Q K^T is wgmma m64n128k32 s8 with both operands in shared memory
//    (s8 wgmma takes K-major operands only), into 64 s32 registers a thread,
//    the same accumulator layout as an fp32 S;
//  - int32 -> fp32 without I2F: every score has |s| <= 64 * 127^2 =
//    1,032,256 < 2^22, so __int_as_float(s + 0x4B400000) - 12582912.f is
//    exact (0x4B400000 is 1.5 * 2^23, whose ulp is 1): an integer add and a
//    float add where the I2F was, then the one multiply by the tile's factor
//    sm_scale * sq * sk * log2(e). The subtraction is not folded into an FMA
//    with the factor: that would round the constant. The k-block of the
//    factor advances by a count and the paged key mask steps its page offset
//    by additions, so no division (whose reciprocal takes an I2F) is left in
//    the key loop either;
//  - softmax as in flash_fwd_wgmma.cu: exp2 domain, fp32 running max and
//    denominator, the key mask only on tiles that hold a masked key, the
//    plain-mode loop ending at the last tile with a valid key; O is rescaled
//    only when a row of the warp has a new max (otherwise every alpha is
//    exactly 1);
//  - in the bf16 P.V mode a tile without a masked key first skips the max
//    pass: softmax is shift-invariant, so p = exp2(s f - m) may take the
//    running max as it stands while p stays finite and not far above 1. Each
//    thread checks its row sums (at most LAZY_LIMIT), the warpgroup votes with
//    bar.red.or, and if any row's max grew past that (or p overflowed) it
//    issues S again and takes the exact softmax. That drops the max pass's
//    compares, shuffles and exp2 of alpha, and the wait between the max and
//    the exponentials, from nearly every tile. The int8 P.V mode keeps the
//    max pass: its round(P * 127) needs P <= 1;
//  - bf16 P.V: flash_fwd_wgmma.cu's register-A wgmma m64n64k16 with P packed
//    from the accumulators and V read MN-major through the transpose bit;
//    S_{j+1} is issued with P_j V_j and its softmax runs while P_j V_j is in
//    flight, and the two consumer warpgroups take turns on the tensor cores
//    through named barriers (ping-pong);
//  - int8 P.V: register-A wgmma m64n64k32 s8 with A = round(P * 127).
//    Rounding without F2I: fmaf(p, 127, 12582912) rounds p * 127 half to even
//    into the low byte of the float's bits, and two byte permutes pack four.
//    The s8 A fragment holds 4 consecutive k per register, the score
//    accumulator 2 consecutive keys per 8-key chunk: so the wrapper writes
//    V^T with its key columns permuted within each 16-key group (position
//    4t + i holds key 2t + i for i < 2, key 8 + 2t + i - 2 for i >= 2), and
//    the A register of 4 positions packs the thread's two key pairs of
//    neighbouring chunks without a shuffle. The accumulator's key order, and
//    with it the mask, is unchanged. The tile's int32 product (at most
//    128 * 127^2 < 2^22) becomes fp32 by the same exact trick, times
//    sv / 127, into the fp32 O. This mode takes two turns a tile (S, then
//    P V) and no overlap within the warpgroup: with the s32 product live
//    beside S, O and P, the overlapped order spilled and was slower;
//  - what limits it (exploratory builds on the card, PERF.md): the softmax's
//    instructions and their latency, not the tensor cores, the exp2 unit or
//    the loads. Leaving out P.V saves less time than leaving out the
//    softmax; loads that stop after the first stages, more stages, or a share
//    of the exp2 moved to an FMA polynomial do not help (the last one costs).
//    With the max pass the softmax takes 6 instructions a score (the
//    conversion's two, max, FMA, exp2, sum) against flash_fwd_wgmma.cu's 4,
//    and the halved Q.K^T time bought only parity with the bf16 kernel;
//    without it, 5.

#include "hopper.cuh"
#include "int8_wgmma.cuh"

namespace {

using namespace hopper;
using namespace int8_wgmma;

struct Params {
  __nv_bfloat16* o;
  const float* sq;      // [B*H, nq]
  const float* sk;      // [B*H, nk]
  const float* sv;      // [B*H, nk] (int8 P.V mode)
  long long o_sb, o_sh, o_ss;
  int H, S_q, S_k, kv_len, kv_page, blk_q, nq, nk;
  int kblk_tiles;       // key tiles per blk_k block
  float sm_scale;
};

// Which of the thread's 32 key columns of a tile are valid: bit 2c + e for
// column n0 + 8c + 2t + e. Paged mode takes the page offset of column n0 + 2t
// (page_off) and steps it by additions: a division per column would compute
// its reciprocal with an I2F each time.
__device__ __forceinline__ uint32_t valid_keys(const Params& p, int n0, int t, int page_off) {
  uint32_t bits = 0;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * c + 2 * t + e;
      bool valid;
      if (p.kv_page) {
        const int off = page_off + e < p.kv_page ? page_off + e : page_off + e - p.kv_page;
        valid = col < p.S_k && off < p.kv_len;
      } else {
        valid = col < p.kv_len;
      }
      bits |= static_cast<uint32_t>(valid) << (2 * c + e);
    }
    if (p.kv_page) {
      page_off += 8;
      while (page_off >= p.kv_page) page_off -= p.kv_page;
    }
  }
  return bits;
}

// int32 scores of one key tile into probabilities (fp32 bits, in place), the
// running max and denominator updated, alpha = the factor that rescales O;
// f = sm_scale * sq * sk * log2(e) of the tile. Rows g and g + 8 of the warp:
// accumulator registers i with (i >> 1) & 1 = 0, 1.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(uint32_t (&s)[64], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], float f,
                                             const Params& p, int n0, int t, int page_off) {
  float mx[2];
  if (MASK) {
    mx[0] = m_run[0];
    mx[1] = m_run[1];
    const uint32_t valid = valid_keys(p, n0, t, page_off);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const bool ok = (valid >> (2 * (i >> 2) + (i & 1))) & 1u;
      const float x = ok ? s32_to_f32(s[i]) * f : MASKED;
      s[i] = __float_as_uint(x);
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
  } else {
    // max(s) * f = max(s * f) for f > 0: the factor joins the exp2's FMA below
    float r[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float x = s32_to_f32(s[i]);
      s[i] = __float_as_uint(x);
      r[(i >> 1) & 1] = fmaxf(r[(i >> 1) & 1], x);
    }
    mx[0] = fmaxf(m_run[0], r[0] * f);
    mx[1] = fmaxf(m_run[1], r[1] * f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m_run[r] - mx[r]);
    m_run[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float x = __uint_as_float(s[i]);
    const float pe = MASK ? ex2(x - mx[r]) : ex2(fmaf(x, f, -mx[r]));
    s[i] = __float_as_uint(pe);
    sum[r] += pe;
  }
  l_run[0] = l_run[0] * alpha[0] + sum[0];
  l_run[1] = l_run[1] * alpha[1] + sum[1];
}

// The softmax of a tile without a masked key against the running max as it
// stands, p = exp2(s f - m_run), with no max pass: softmax is shift-invariant,
// so any reference works while it keeps p finite and not far above 1. The
// row sums of the thread's share go to sum; the caller commits them (alpha
// stays 1) when every thread's sums are at most LAZY_LIMIT, and otherwise
// computes S again and takes softmax_tile (a row's max grew by more than
// about log2(LAZY_LIMIT), or p overflowed).
__device__ __forceinline__ bool softmax_lazy(uint32_t (&s)[64], const float (&m_run)[2],
                                             float (&sum)[2], float f) {
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float pe = ex2(fmaf(s32_to_f32(s[i]), f, -m_run[r]));
    s[i] = __float_as_uint(pe);
    sum[r] += pe;
  }
  return sum[0] <= LAZY_LIMIT && sum[1] <= LAZY_LIMIT;   // false for inf and NaN too
}

__device__ __forceinline__ void softmax_any(uint32_t (&s)[64], float (&m_run)[2],
                                            float (&l_run)[2], float (&alpha)[2], float f,
                                            const Params& p, int n0, int t, int page_off) {
  if (p.kv_page || n0 + BN > p.kv_len)
    softmax_tile<true>(s, m_run, l_run, alpha, f, p, n0, t, page_off);
  else
    softmax_tile<false>(s, m_run, l_run, alpha, f, p, n0, t, page_off);
}

template <bool PV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
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
  // plain mode: keys past kv_len contribute exp2(-1e30) = 0; the loop stops there
  const int kv_end = p.kv_page ? p.S_k : p.kv_len;
  const int n_tiles = (kv_end + BN - 1) / BN;

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

  // the role, made warp-uniform for the compiler: each branch then gets its
  // own register budget from setmaxnreg
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
    // ping-pong, as in flash_fwd_wgmma.cu: warpgroup w waits on barrier 1 + w
    // before issuing its products and then lets the other one go; the last
    // hand-over of warpgroup 1 would have no taker and is left out.
    const int my_bar = 1 + w, other_bar = 2 - w;
    if (w == 1) bar_arrive(other_bar, 256);
    auto hand_over = [&](bool last) {
      if (w == 0 || !last) bar_arrive(other_bar, 256);
    };

    // The factors of the tiles in order: f = sm_scale * sq * sk * log2(e),
    // the scale product in fp32 first as the TPU kernel forms it, and
    // dpv = sv / 127. The k-block advances by a count, not a division (whose
    // reciprocal would put an I2F back into the key loop).
    const float sq_blk = p.sq[static_cast<long long>(bh) * p.nq + m0 / p.blk_q];
    const float* sk_row = p.sk + static_cast<long long>(bh) * p.nk;
    const float* sv_row = p.sv + static_cast<long long>(bh) * p.nk;
    int kblk = 0, kblk_left = p.kblk_tiles;
    auto next_factors = [&](float& f, float& dpv) {
      f = (p.sm_scale * (sq_blk * sk_row[kblk])) * LOG2E;
      if (PV) dpv = sv_row[kblk] * (1.f / 127.f);
      if (--kblk_left == 0) {
        ++kblk;
        kblk_left = p.kblk_tiles;
      }
    };

    // paged mode: (n0 + 2t) % kv_page of the current tile, stepped by additions
    int page_off = 2 * t;
    auto next_page = [&](int step) {
      if (p.kv_page) {
        page_off += step;
        while (page_off >= p.kv_page) page_off -= p.kv_page;
      }
    };
    next_page(0);

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
    // O *= alpha, skipped when no row of the warp has a new max (every alpha
    // is then exactly 1)
    auto rescale = [&]() {
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
    };
    float f, dpv = 0.f;
    mbar_wait(bar_q, 0);

    if constexpr (!PV) {
      // bf16 P.V: S_{j+1} is issued with P_j V_j and its softmax runs while
      // P_j V_j is in flight
      next_factors(f, dpv);
      mbar_wait(full_k(0), 0);
      bar_sync(my_bar, 256);
      wgmma_fence();
      issue_qk(s, qdesc, kdesc(0));
      wgmma_commit();
      hand_over(n_tiles == 1);
      wgmma_wait<0>();
      keep(s);
      softmax_any(s, m_run, l_run, alpha, f, p, 0, t, page_off);
      pack_p<PV>(pa, s);
      for (int j = 1; j < n_tiles; ++j) {
        const int st = j % STAGES, pst = (j - 1) % STAGES;
        next_factors(f, dpv);                            // loaded ahead of their use
        next_page(BN);
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
        bool exact = p.kv_page || (j + 1) * BN > p.kv_len;
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
        if (exact) softmax_any(s, m_run, l_run, alpha, f, p, j * BN, t, page_off);
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
      // int8 P.V: two turns a tile (S, then P V), no overlap within the
      // warpgroup: with the s32 product beside S and O the overlapped order
      // spilled and was slower
      uint32_t acc[32];
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        next_factors(f, dpv);
        if (j > 0) next_page(BN);
        mbar_wait(full_k(st), (j / STAGES) & 1);
        bar_sync(my_bar, 256);
        wgmma_fence();
        issue_qk(s, qdesc, kdesc(st));
        wgmma_commit();
        hand_over(false);
        wgmma_wait<0>();
        keep(s);
        softmax_any(s, m_run, l_run, alpha, f, p, j * BN, t, page_off);
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
        for (int i = 0; i < 32; ++i) o[i] += s32_to_f32(acc[i]) * dpv;
        mbar_arrive(empty(st));
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const int r0 = m0 + w * 64 + warp * 16 + g, r1 = r0 + 8;
    const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
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
  int rc = check_registers(flash_int8_wgmma_kernel<PV>, NTHREADS, 128, PRODUCER_REGS,
                           CONSUMER_REGS);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_int8_wgmma_kernel<PV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<PV>::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S_q + BM - 1) / BM, B * p.H);
  flash_int8_wgmma_kernel<PV><<<grid, NTHREADS, Tile<PV>::SMEM_BYTES, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k: int8 [B, H, S, 64] addressed by element strides (last dim contiguous,
// every stride a multiple of 16, 16-byte aligned bases). v: bf16
// [B, H, S_k, 64] (strides multiples of 8), or with int8_pv the transposed
// int8 V^T [B, H, 64, S_k padded with zeros to a multiple of 128] whose key
// columns are permuted within each 16-key group (position 4t + i holds key
// 2t + i for i < 2, 8 + 2t + i - 2 for i >= 2; v_ss = the row stride of V^T).
// o: bf16 [B, H, S_q, 64] by strides. sq [B*H, nq], sk and sv [B*H, nk] fp32,
// one scale per blk_q rows / blk_k keys; blk_q % 128 == 0 and
// blk_k % 128 == 0. kv_page = 0 selects the plain mask. Returns the
// cudaError_t of the launch, or a negative hopper::ERR_* code.
extern "C" int vp_flash_int8_fwd(const void* q, const void* k, const void* v, void* o,
                                 const void* sq, const void* sk, const void* sv,
                                 int B, int H, int S_q, int S_k,
                                 long long q_sb, long long q_sh, long long q_ss,
                                 long long k_sb, long long k_sh, long long k_ss,
                                 long long v_sb, long long v_sh, long long v_ss,
                                 long long o_sb, long long o_sh, long long o_ss,
                                 float sm_scale, int kv_len, int kv_page,
                                 int blk_q, int blk_k, int int8_pv, void* stream) {
  if (sq == nullptr || sk == nullptr || (int8_pv && sv == nullptr) || blk_q % BM != 0 ||
      blk_k % BN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.sq = static_cast<const float*>(sq);
  p.sk = static_cast<const float*>(sk);
  p.sv = static_cast<const float*>(sv);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.H = H; p.S_q = S_q; p.S_k = S_k; p.kv_len = kv_len; p.kv_page = kv_page;
  p.blk_q = blk_q; p.kblk_tiles = blk_k / BN;
  p.nq = (S_q + blk_q - 1) / blk_q; p.nk = (S_k + blk_k - 1) / blk_k;
  p.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int8_pv ? launch<true>(tq, tk, tv, p, B, st) : launch<false>(tq, tk, tv, p, B, st);
}
