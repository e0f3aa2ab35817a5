// Bidirectional flash-attention forward for Hopper (sm_90a), bf16 in/out:
// warp-specialised, fed by TMA through an mbarrier ring, products on wgmma.
//
// Replaces videopainter_tpu/ops/flash_attention.py::_flash_kernel (launched by
// _flash_padded). Same function as the mma.sync kernel it supersedes
// (flash_fwd.cu, kept as a yardstick): softmax(scale * Q K^T, masked) V per
// (batch, head), an online softmax whose running max, denominator and output
// accumulator are fp32, bf16 operands with fp32 accumulation, P rounded to
// bf16 before P.V. Key validity is the TPU kernel's _kv_valid: plain mode
// `col < kv_len`, paged mode `(col < S_k) && (col % kv_page < kv_len)`.
// Masked scores are -1e30 (finite, as on the TPU). Optional per-row
// logsumexp (natural log) in fp32, m * ln2 + log(l).
//
// What bounds it on the H100: operations, 4*B*H*S_q*S_k*d. At the flagship
// shape (B*H = 96, S = 17,776, d = 64) that is 7.8 TFLOP, 7.85 ms at the
// 989 TFLOP/s dense bf16 peak, against 0.87 GB of q/k/v/o (0.26 ms at
// 3.35 TB/s). Next to the tensor cores, the softmax's ex2 is the scarce unit:
// a 64 x 128 score tile costs as many cycles of the SM's 16 exp2 units as its
// two products cost on the tensor cores. So the design keeps both busy:
//  - one block per (128 query rows, b*h): warpgroup 0 is the producer, 1 and
//    2 the consumers, 64 query rows each, one block per SM. The producer
//    gives up registers with setmaxnreg (40 / 232), but ptxas (CUDA 12.9)
//    still compiles every region within the 168 registers a thread has at
//    launch (the mma.sync kernel had 128): S (64 fp32 a thread), O (32) and
//    the packed P (32) live across the overlap below, and 68 bytes spill;
//  - one producer thread issues every load: Q once, then K and V tiles of
//    128 keys into a 3-stage ring, each stage guarded by a full barrier per
//    operand (TMA byte count) and an empty barrier (all 256 consumer
//    threads). TMA computes the addresses from 4-D tensor maps over
//    (d, S, H, B), so strided head views need no copy, and zero-fills rows
//    past S_q / S_k: keys there are masked, query rows are not stored;
//  - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major, 128-byte swizzle, 4 k-steps over d); O += P V is wgmma
//    m64n64k16 with P from registers, packed to bf16 straight from S's
//    accumulator layout, and V read MN-major through the transpose bit
//    (8 k-steps over the keys), no transposing copy;
//  - overlap, within a warpgroup: S_{j+1} and P_j V_j are issued together
//    and the softmax of S_{j+1} runs while P_j V_j is in flight; between the
//    two consumer warpgroups: they take turns on the tensor cores through
//    two named barriers (ping-pong), so one's softmax runs while the other's
//    products do;
//  - softmax in the exp2 domain (scale * log2(e) folded into one multiply,
//    ex2.approx.ftz), the per-element key mask applied only on tiles that
//    hold a masked key. Paged mode streams every tile; a tile whose keys are
//    all masked could be skipped exactly (key 0 is always valid, kv_len >= 1,
//    so the running max is finite from the first tile on), but no path of
//    the port uses the paged mask for speed.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 64;
constexpr int BM = 128;             // query rows per block: 2 consumer warpgroups x 64
constexpr int BN = 128;             // keys per streamed tile
constexpr int STAGES = 3;
constexpr int NTHREADS = 384;       // producer warpgroup + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int Q_BYTES = BM * D * 2;
constexpr int KV_BYTES = BN * D * 2;
constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + 8 * (1 + 3 * STAGES);  // + alignment slack
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  __nv_bfloat16* o;
  float* lse;
  long long o_sb, o_sh, o_ss;
  int H, S_q, S_k, kv_len, kv_page;
  float scale_log2;
};

// Scores of one key tile into probabilities (fp32, in place), the running
// max and denominator updated, alpha = the factor that rescales O. Rows
// g and g + 8 of the warp: accumulator registers i with (i >> 1) & 1 = 0, 1.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2],
                                             const Params& p, int n0, int t) {
  float mx[2];
  if (MASK) {
    mx[0] = m_run[0];
    mx[1] = m_run[1];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const bool valid = p.kv_page ? (col < p.S_k && (col % p.kv_page) < p.kv_len)
                                   : (col < p.kv_len);
      const float x = valid ? s[i] * p.scale_log2 : MASKED;
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
  } else {
    // max(s) * c = max(s * c) for c > 0: the scale joins the exp2's FMA below
    float r[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) r[(i >> 1) & 1] = fmaxf(r[(i >> 1) & 1], s[i]);
    mx[0] = fmaxf(m_run[0], r[0] * p.scale_log2);
    mx[1] = fmaxf(m_run[1], r[1] * p.scale_log2);
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
    const float pe = MASK ? ex2(s[i] - mx[r]) : ex2(fmaf(s[i], p.scale_log2, -mx[r]));
    s[i] = pe;
    sum[r] += pe;
  }
  l_run[0] = l_run[0] * alpha[0] + sum[0];
  l_run[1] = l_run[1] * alpha[1] + sum[1];
}

// P (bf16) as the A fragments of the 8 k-steps of P V: the m16n8k16 A layout
// of the warp's 16 rows is S's accumulator layout, two 8-key chunks per step
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t qdesc, uint32_t k_tile) {
  const uint64_t kdesc = desc_sw128(k_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_m64n128(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
}

__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[8][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs_m64n64_tb(o, pa[kk], desc_sw128(v_tile + kk * 16 * 128, 1024, 1024));
}

__device__ __forceinline__ void softmax_any(float (&s)[64], float (&m_run)[2], float (&l_run)[2],
                                            float (&alpha)[2], const Params& p, int n0, int t) {
  if (p.kv_page || n0 + BN > p.kv_len)
    softmax_tile<true>(s, m_run, l_run, alpha, p, n0, t);
  else
    softmax_tile<false>(s, m_run, l_run, alpha, p, n0, t);
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // 128-byte swizzle: 1 KB
  const uint32_t sq = base;
  const uint32_t sk = sq + Q_BYTES;
  const uint32_t sv = sk + STAGES * KV_BYTES;
  const uint32_t bars = base + BAR_OFFSET;
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
        mbar_arrive_expect_tx(full_k(s), KV_BYTES);
        tma_load_4d(sk + s * KV_BYTES, &tk, full_k(s), 0, j * BN, h, b);
        mbar_arrive_expect_tx(full_v(s), KV_BYTES);
        tma_load_4d(sv + s * KV_BYTES, &tv, full_v(s), 0, j * BN, h, b);
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
    // products and then lets the other one go; warpgroup 0 goes first. The
    // last hand-over of warpgroup 1 would have no taker and is left out.
    const int my_bar = 1 + w, other_bar = 2 - w;
    if (w == 1) bar_arrive(other_bar, 256);
    auto hand_over = [&](bool last) {
      if (w == 0 || !last) bar_arrive(other_bar, 256);
    };

    const uint64_t qdesc = desc_sw128(sq + w * 64 * 128, 16, 1024);
    float s[64], o[32];
    uint32_t pa[8][4];
    float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;

    mbar_wait(bar_q, 0);
    mbar_wait(full_k(0), 0);
    bar_sync(my_bar, 256);
    wgmma_fence();
    issue_qk(s, qdesc, sk);
    wgmma_commit();
    hand_over(n_tiles == 1);
    wgmma_wait<0>();
    keep(s);
    softmax_any(s, m_run, l_run, alpha, p, 0, t);
    pack_p(pa, s);

    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % STAGES, pst = (j - 1) % STAGES;
      mbar_wait(full_k(st), (j / STAGES) & 1);
      bar_sync(my_bar, 256);
      wgmma_fence();
      issue_qk(s, qdesc, sk + st * KV_BYTES);          // S_j
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      mbar_wait(full_v(pst), ((j - 1) / STAGES) & 1);
      wgmma_fence();
      issue_pv(o, pa, sv + pst * KV_BYTES);            // O += P_{j-1} V_{j-1}
      wgmma_commit();
      hand_over(j == n_tiles - 1);
      wgmma_wait<1>();                                 // S_j done; P V in flight
      keep(s);
      softmax_any(s, m_run, l_run, alpha, p, j * BN, t);
      wgmma_wait<0>();
      keep(o);
      keep(pa);
      mbar_arrive(empty(pst));
      pack_p(pa, s);
    }
    const int lst = (n_tiles - 1) % STAGES;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    mbar_wait(full_v(lst), ((n_tiles - 1) / STAGES) & 1);
    wgmma_fence();
    issue_pv(o, pa, sv + lst * KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    keep(o);
    keep(pa);

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
    if (p.lse != nullptr && t == 0) {
      float* lb = p.lse + static_cast<long long>(bh) * p.S_q;
      if (r0 < p.S_q) lb[r0] = m_run[0] * LN2 + logf(l_run[0]);
      if (r1 < p.S_q) lb[r1] = m_run[1] * LN2 + logf(l_run[1]);
    }
  }
}

}  // namespace

// q, k, v, o: [B, H, S, 64] bf16 addressed by element strides (the last dim
// contiguous, every stride a multiple of 8, 16-byte aligned bases); lse:
// [B, H, S_q] fp32 or null. kv_page = 0 selects the plain mask. Returns the
// cudaError_t of the launch, or a negative hopper::ERR_* code.
extern "C" int vp_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int H, int S_q, int S_k,
                            long long q_sb, long long q_sh, long long q_ss,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            long long o_sb, long long o_sh, long long o_ss,
                            float scale, int kv_len, int kv_page, void* stream) {
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, H, S_q, q_sb, q_sh, q_ss, BM);
  if (rc == 0) rc = make_map(&tk, k, B, H, S_k, k_sb, k_sh, k_ss, BN);
  if (rc == 0) rc = make_map(&tv, v, B, H, S_k, v_sb, v_sh, v_ss, BN);
  if (rc == 0)
    rc = check_registers(flash_fwd_wgmma_kernel, NTHREADS, 128, PRODUCER_REGS, CONSUMER_REGS);
  if (rc != 0) return rc;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.H = H; p.S_q = S_q; p.S_k = S_k; p.kv_len = kv_len; p.kv_page = kv_page;
  p.scale_log2 = scale * LOG2E;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S_q + BM - 1) / BM, B * H);
  flash_fwd_wgmma_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}
