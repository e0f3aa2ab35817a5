// dQ of bidirectional flash attention for Hopper (sm_90a), bf16 in/out:
// warp-specialised, fed by TMA through an mbarrier ring, products on wgmma.
//
// Replaces videopainter_tpu/ops/flash_attention.py::_flash_dq_kernel
// (launched by _flash_bwd_padded). Same entry point, function and numerics
// as the mma.sync kernel it supersedes (vp_flash_dq in flash_bwd.cu, kept as
// a yardstick): with the forward's per-row logsumexp `lse` and
// delta = rowsum(dO * O),
//   P  = exp2(S * scale * log2(e) - lse * log2(e)) under the key mask
//        (masked keys: exactly 0), as the forward kernel makes P,
//   dP = dO V^T,   dS = P * (dP - delta) * scale,   dQ = dS K,
// bf16 operands with fp32 accumulation, dS rounded to bf16 before its
// product. No atomics: dK / dV are the separate kernel vp_flash_dkv
// (flash_dkv_wgmma.cu), so the gradients are deterministic.
//
// What bounds it on the H100: operations, 6*B*H*S_q*S_k*d (three
// score-sized products). At [1x48, 17,776, 64] that is 5.8 TFLOP, 5.89 ms at
// the 989 TFLOP/s dense bf16 peak, against 0.2 GB of operands. The mma.sync
// kernel issued its products synchronously from the warps that also ran
// exp2 and dS, and reached 26 % of that bound. Here flash_dkv_wgmma.cu's
// design with the roles turned around:
//  - one block per (128 query rows, b*h): warpgroup 0 is the producer, 1 and
//    2 the consumers, 64 query rows each; setmaxnreg 40 / 232. dQ, S and dP
//    are 32 fp32 registers a thread each, the packed dS 16;
//  - one producer thread loads Q and dO once (TMA, 128 rows) and streams
//    64-key K and V tiles through a 3-stage ring (a full barrier with the
//    TMA byte count, an empty barrier of the 256 consumer threads). Each
//    consumer thread reads the lse (times log2(e)) and delta of its two rows
//    into registers once;
//  - per tile, S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both
//    operands in shared memory (K-major, 128-byte swizzle); dQ += dS K is
//    wgmma m64n64k16 with dS from registers (bf16-packed from the
//    accumulators) and K read MN-major through the transpose bit, as the
//    forward reads V;
//  - overlap: the two consumer warpgroups take turns on the tensor cores
//    through two named barriers (ping-pong), twice a tile (S and dP, then
//    dQ), so one's exp2 and dS work runs while the other's products do;
//  - ragged tails need no padding: TMA zero-fills Q and dO rows past S_q,
//    which get lse = +1e30, so their P is exp2(-1e30) = 0 and their dS
//    exactly 0; they are not stored. Keys past S_k are masked (P = 0) and
//    their K rows are zeros. In plain mode the key loop stops at the last
//    tile that holds a valid key; paged mode masks per tile.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 64;
constexpr int BM = 128;             // query rows per block: 2 consumer warpgroups x 64
constexpr int BN = 64;              // keys per streamed tile
constexpr int STAGES = 3;
constexpr int NTHREADS = 384;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int Q_BYTES = BM * D * 2;
constexpr int KV_BYTES = BN * D * 2;
constexpr int BAR_OFFSET = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + 8 * (1 + 2 * STAGES);
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NO_ROW = 1e30f;     // lse of a query row past S_q: P = exp2(-1e30) = 0

struct Params {
  const float* lse;    // [B, H, S_q]
  const float* delta;  // [B, H, S_q]
  __nv_bfloat16* dq;
  long long dq_sb, dq_sh, dq_ss;
  int H, S_q, S_k, kv_len, kv_page;
  float scale, scale_log2;
};

__device__ __forceinline__ bool key_valid(const Params& p, int col) {
  return p.kv_page ? (col < p.S_k && (col % p.kv_page) < p.kv_len) : (col < p.kv_len);
}

// S = Q K^T and dP = dO V^T for one streamed tile (4 k-steps over d)
__device__ __forceinline__ void issue_scores(float (&s)[32], float (&dp)[32], uint64_t qdesc,
                                             uint64_t dodesc, uint32_t k_tile, uint32_t v_tile) {
  const uint64_t kdesc = desc_sw128(k_tile, 16, 1024);
  const uint64_t vdesc = desc_sw128(v_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_m64n64(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_m64n64(dp, dodesc + 2 * kk, vdesc + 2 * kk, kk);
}

// dQ += dS K (4 k-steps over the tile's 64 keys, K read MN-major)
__device__ __forceinline__ void issue_dq(float (&dq)[32], const uint32_t (&dsa)[4][4],
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs_m64n64_tb(dq, dsa[kk], desc_sw128(k_tile + kk * 16 * 128, 1024, 1024));
}

// dS of one tile, packed to bf16 as the A fragments of dS K. Accumulator
// register i: query row g (i & 2 == 0) or g + 8, key column
// n0 + 8 (i >> 2) + 2 t + (i & 1).
template <bool MASK>
__device__ __forceinline__ void ds_tile(uint32_t (&dsa)[4][4], const float (&s)[32],
                                        const float (&dp)[32], const float (&lse2)[2],
                                        const float (&dl)[2], const Params& p, int n0, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      float pe = ex2(s[i] * p.scale_log2 - lse2[e >> 1]);
      if (MASK && !key_valid(p, n0 + 8 * n + 2 * t + (e & 1))) pe = 0.f;
      ds[e] = pe * (dp[i] - dl[e >> 1]) * p.scale;
    }
    dsa[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
    dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// the warp's rows r0 = g and r0 + 8 of a 64 x 64 fp32 accumulator to bf16 rows
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long stride,
                                           const float (&acc)[32], int r0, int limit, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(base + r0 * stride + col) =
          __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
    if (r1 < limit)
      *reinterpret_cast<__nv_bfloat162*>(base + r1 * stride + col) =
          __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // 128-byte swizzle: 1 KB
  const uint32_t sq = base;
  const uint32_t sdo = sq + Q_BYTES;
  const uint32_t sk = sdo + Q_BYTES;                 // STAGES tiles
  const uint32_t sv = sk + STAGES * KV_BYTES;        // STAGES tiles
  const uint32_t bars = base + BAR_OFFSET;
  const uint32_t bar_q = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int m0 = blockIdx.x * BM;
  // plain mode: keys past kv_len have P = 0, so the loop stops at kv_len
  const int kv_end = p.kv_page ? p.S_k : p.kv_len;
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
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
      mbar_arrive_expect_tx(bar_q, 2 * Q_BYTES);
      tma_load_4d(sq, &tq, bar_q, 0, m0, h, b);
      tma_load_4d(sdo, &tdo, bar_q, 0, m0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);   // the first round passes at once
        mbar_arrive_expect_tx(full(s), 2 * KV_BYTES);
        tma_load_4d(sk + s * KV_BYTES, &tk, full(s), 0, j * BN, h, b);
        tma_load_4d(sv + s * KV_BYTES, &tv, full(s), 0, j * BN, h, b);
      }
    }
  } else {
    // ---- consumers: warpgroup w owns query rows m0 + 64 w .. + 63 ----
    regs_inc<CONSUMER_REGS>();
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // ping-pong on named barriers, as in flash_dkv_wgmma.cu, two turns a tile
    const int my_bar = 1 + w, other_bar = 2 - w;
    if (w == 1) bar_arrive(other_bar, 256);
    auto hand_over = [&](bool last) {
      if (w == 0 || !last) bar_arrive(other_bar, 256);
    };

    const uint64_t qdesc = desc_sw128(sq + w * 64 * 128, 16, 1024);
    const uint64_t dodesc = desc_sw128(sdo + w * 64 * 128, 16, 1024);
    const int r0 = m0 + w * 64 + warp * 16 + g, r1 = r0 + 8;
    const float* lse_b = p.lse + static_cast<long long>(bh) * p.S_q;
    const float* dl_b = p.delta + static_cast<long long>(bh) * p.S_q;
    const float lse2[2] = {r0 < p.S_q ? lse_b[r0] * LOG2E : NO_ROW,
                           r1 < p.S_q ? lse_b[r1] * LOG2E : NO_ROW};
    const float dl[2] = {r0 < p.S_q ? dl_b[r0] : 0.f, r1 < p.S_q ? dl_b[r1] : 0.f};
    float dq[32], s[32], dp[32];
    uint32_t dsa[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int n0 = j * BN;
      mbar_wait(full(st), (j / STAGES) & 1);
      bar_sync(my_bar, 256);
      wgmma_fence();
      issue_scores(s, dp, qdesc, dodesc, sk + st * KV_BYTES, sv + st * KV_BYTES);
      wgmma_commit();
      hand_over(false);
      wgmma_wait<0>();
      keep(s);
      keep(dp);
      if (p.kv_page || n0 + BN > p.kv_len)
        ds_tile<true>(dsa, s, dp, lse2, dl, p, n0, t);
      else
        ds_tile<false>(dsa, s, dp, lse2, dl, p, n0, t);
      bar_sync(my_bar, 256);
      wgmma_fence();
      issue_dq(dq, dsa, sk + st * KV_BYTES);
      wgmma_commit();
      hand_over(j == n_tiles - 1);
      wgmma_wait<0>();
      keep(dq);
      keep(dsa);
      mbar_arrive(empty(st));
    }

    store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, dq, r0, p.S_q, t);
  }
}

}  // namespace

// q, k, v, dout, dq: [B, H, S, 64] bf16 addressed by element strides (the
// last dim contiguous, every stride a multiple of 8, 16-byte aligned bases);
// lse, delta: [B, H, S_q] fp32 contiguous. kv_page = 0 selects the plain
// mask. Returns the cudaError_t of the launch, or a negative hopper::ERR_* code.
extern "C" int vp_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq,
                           int B, int H, int S_q, int S_k,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long do_sb, long long do_sh, long long do_ss,
                           long long dq_sb, long long dq_sh, long long dq_ss,
                           float scale, int kv_len, int kv_page, void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, B, H, S_q, q_sb, q_sh, q_ss, BM);
  if (rc == 0) rc = make_map(&tk, k, B, H, S_k, k_sb, k_sh, k_ss, BN);
  if (rc == 0) rc = make_map(&tv, v, B, H, S_k, v_sb, v_sh, v_ss, BN);
  if (rc == 0) rc = make_map(&tdo, dout, B, H, S_q, do_sb, do_sh, do_ss, BM);
  if (rc == 0)
    rc = check_registers(flash_dq_wgmma_kernel, NTHREADS, 128, PRODUCER_REGS, CONSUMER_REGS);
  if (rc != 0) return rc;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  p.H = H; p.S_q = S_q; p.S_k = S_k; p.kv_len = kv_len; p.kv_page = kv_page;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S_q + BM - 1) / BM, B * H);
  flash_dq_wgmma_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}
