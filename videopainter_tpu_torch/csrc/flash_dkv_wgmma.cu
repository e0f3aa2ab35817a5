// dK / dV of bidirectional flash attention for Hopper (sm_90a), bf16 in/out:
// warp-specialised, fed by TMA through an mbarrier ring, products on wgmma.
//
// Replaces videopainter_tpu/ops/flash_attention.py::_flash_dkv_kernel
// (launched by _flash_bwd_padded). Same function as the mma.sync kernel it
// supersedes (vp_flash_dkv in flash_bwd.cu, kept as a yardstick): with the
// forward's per-row logsumexp `lse` and delta = rowsum(dO * O),
//   P^T  = exp2(S^T * scale * log2(e) - lse * log2(e)) under the key mask
//          (masked keys: exactly 0), as the forward kernel makes P,
//   dS^T = P^T * (dP^T - delta) * scale,   dV = P^T dO,   dK = dS^T Q,
// bf16 operands with fp32 accumulation, P and dS rounded to bf16 before
// their products. No atomics: dQ is the separate kernel vp_flash_dq, so the
// gradients are deterministic.
//
// What bounds it on the H100: operations, 8*B*H*S_q*S_k*d (four score-sized
// products). At [1x48, 17,776, 64] that is 7.8 TFLOP, 7.85 ms at the
// 989 TFLOP/s dense bf16 peak, against 0.3 GB of operands. The mma.sync
// kernel ran one block of 8 warps per SM on 255 registers and spilled; here:
//  - one block per (128 keys, b*h): warpgroup 0 is the producer, 1 and 2 the
//    consumers, 64 keys each. The producer gives up registers with
//    setmaxnreg (40 / 232), but ptxas (CUDA 12.9) still compiles every
//    region within the 168 registers a thread has at launch (its SASS uses
//    up to R155). That holds the four 64 x 64 fp32 accumulators (dK, dV,
//    S^T, dP^T: 32 registers a thread each) and the packed P^T and dS^T
//    without a spill;
//  - the producer warp loads K and V once (TMA, 128 rows) and streams
//    64-row Q and dO tiles through a 2-stage ring, with their lse (times
//    log2(e)) and delta rows, which its 32 lanes write to shared memory
//    before they arrive on the stage's full barrier (32 arrivals plus the
//    TMA byte count); the empty barrier takes all 256 consumer threads;
//  - per tile, S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both
//    operands in shared memory (K-major, 128-byte swizzle); dV += P^T dO and
//    dK += dS^T Q are wgmma m64n64k16 with A from registers (bf16-packed
//    from the accumulators) and dO / Q read MN-major through the transpose
//    bit;
//  - overlap: the two consumer warpgroups take turns on the tensor cores
//    through two named barriers (ping-pong), twice a tile (S^T and dP^T,
//    then dV and dK), so one's exp2 and dS work runs while the other's
//    products do. Issuing tile j's S^T / dP^T together with tile j - 1's
//    dV / dK, as the forward overlaps within a warpgroup, keeps all four
//    accumulators in flight: ptxas then serialises the wgmmas (warning
//    C7512, "insufficient register resources", even in a build allowed 232
//    registers), and that version was slower than the mma.sync kernel;
//  - ragged tails need no padding: TMA zero-fills Q and dO rows past S_q,
//    and those rows get lse = +1e30, so their P is exp2(0 - 1e30) = 0
//    exactly; with dO = 0 their dP is 0 and dS = 0 * (0 - 0) = 0: they add
//    exact zeros to dV and dK. Keys past S_k or masked get P = 0, so their
//    dK / dV rows are exactly 0; rows past S_k are not stored. In plain mode
//    a block whose keys are all masked writes zeros and returns.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 64;
constexpr int BK = 128;             // keys per block: 2 consumer warpgroups x 64
constexpr int BQ = 64;              // query rows per streamed tile
constexpr int STAGES = 2;
constexpr int NTHREADS = 384;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int KV_BYTES = BK * D * 2;
constexpr int QT_BYTES = BQ * D * 2;
constexpr int ROWS_OFFSET = 2 * KV_BYTES + 2 * STAGES * QT_BYTES;     // lse, delta
constexpr int BAR_OFFSET = ROWS_OFFSET + 2 * STAGES * BQ * 4;
constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + 8 * (1 + 2 * STAGES);
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NO_ROW = 1e30f;     // lse of a query row past S_q: P = exp2(-1e30) = 0

struct Params {
  const float* lse;    // [B, H, S_q]
  const float* delta;  // [B, H, S_q]
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int H, S_q, S_k, kv_len, kv_page;
  float scale, scale_log2;
};

__device__ __forceinline__ bool key_valid(const Params& p, int col) {
  return p.kv_page ? (col < p.S_k && (col % p.kv_page) < p.kv_len) : (col < p.kv_len);
}

// S^T = K Q^T and dP^T = V dO^T for one streamed tile (4 k-steps over d)
__device__ __forceinline__ void issue_scores(float (&s)[32], float (&dp)[32], uint64_t kdesc,
                                             uint64_t vdesc, uint32_t q_tile, uint32_t do_tile) {
  const uint64_t qdesc = desc_sw128(q_tile, 16, 1024);
  const uint64_t dodesc = desc_sw128(do_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_m64n64(s, kdesc + 2 * kk, qdesc + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_m64n64(dp, vdesc + 2 * kk, dodesc + 2 * kk, kk);
}

// dV += P^T dO and dK += dS^T Q (4 k-steps over the tile's 64 queries)
__device__ __forceinline__ void issue_grads(float (&dv)[32], float (&dk)[32],
                                            const uint32_t (&pa)[4][4],
                                            const uint32_t (&dsa)[4][4], uint32_t q_tile,
                                            uint32_t do_tile) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    wgmma_rs_m64n64_tb(dv, pa[kk], desc_sw128(do_tile + kk * 16 * 128, 1024, 1024));
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    wgmma_rs_m64n64_tb(dk, dsa[kk], desc_sw128(q_tile + kk * 16 * 128, 1024, 1024));
}

// P^T and dS^T of one tile, packed to bf16 as the A fragments of the next
// products. Accumulator register i: key row g (i & 2 == 0) or g + 8, query
// column 8 (i >> 2) + 2 t + (i & 1) of the tile.
__device__ __forceinline__ void probs_tile(uint32_t (&pa)[4][4], uint32_t (&dsa)[4][4],
                                           const float (&s)[32], const float (&dp)[32],
                                           const float* lse_t, const float* dl_t,
                                           const bool (&valid)[2], const Params& p, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_t + n * 8 + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(dl_t + n * 8 + 2 * t);
    float pe[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = (e & 1) ? l2.y : l2.x;
      const float d = (e & 1) ? d2.y : d2.x;
      pe[e] = valid[e >> 1] ? ex2(s[4 * n + e] * p.scale_log2 - l) : 0.f;
      ds[e] = pe[e] * (dp[4 * n + e] - d) * p.scale;
    }
    pa[n >> 1][(n & 1) * 2] = pack_bf16(pe[0], pe[1]);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
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
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const Params p) {
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.x * BK;
  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + h * p.dv_sh;

  // plain mode: a block past kv_len holds masked keys only; their rows are 0
  if (!p.kv_page && n0 >= p.kv_len) {
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = threadIdx.x; i < BK * D / 2; i += NTHREADS) {
      const int row = n0 + i / (D / 2), col = (i % (D / 2)) * 2;
      if (row < p.S_k) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + row * p.dk_ss + col) = zero;
        *reinterpret_cast<__nv_bfloat162*>(dvb + row * p.dv_ss + col) = zero;
      }
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // 128-byte swizzle: 1 KB aligned tiles
  const uint32_t sk = base;
  const uint32_t sv = sk + KV_BYTES;
  const uint32_t sq = sv + KV_BYTES;                 // STAGES tiles
  const uint32_t sdo = sq + STAGES * QT_BYTES;       // STAGES tiles
  float* lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) + ROWS_OFFSET);  // [STAGES][BQ]
  float* dl_s = lse_s + STAGES * BQ;                                               // [STAGES][BQ]
  const uint32_t bars = base + BAR_OFFSET;
  const uint32_t bar_kv = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };

  const int n_tiles = (p.S_q + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);        // the producer warp's lanes (lane 0 with the bytes)
      mbar_init(empty(s), 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the role, made warp-uniform for the compiler: each branch then gets its
  // own register budget from setmaxnreg
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: warp 0 streams Q / dO tiles and their lse / delta ----
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse_b = p.lse + static_cast<long long>(bh) * p.S_q;
      const float* dl_b = p.delta + static_cast<long long>(bh) * p.S_q;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * KV_BYTES);
        tma_load_4d(sk, &tk, bar_kv, 0, n0, h, b);
        tma_load_4d(sv, &tv, bar_kv, 0, n0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int m0 = j * BQ;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);   // the first round passes at once
        for (int i = lane; i < BQ; i += 32) {
          const int row = m0 + i;
          lse_s[s * BQ + i] = row < p.S_q ? lse_b[row] * LOG2E : NO_ROW;
          dl_s[s * BQ + i] = row < p.S_q ? dl_b[row] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full(s), 2 * QT_BYTES);
          tma_load_4d(sq + s * QT_BYTES, &tq, full(s), 0, m0, h, b);
          tma_load_4d(sdo + s * QT_BYTES, &tdo, full(s), 0, m0, h, b);
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns keys n0 + 64 w .. + 63 ----
    regs_inc<CONSUMER_REGS>();
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // ping-pong on named barriers, as in flash_fwd_wgmma.cu, two turns a tile
    const int my_bar = 1 + w, other_bar = 2 - w;
    if (w == 1) bar_arrive(other_bar, 256);
    auto hand_over = [&](bool last) {
      if (w == 0 || !last) bar_arrive(other_bar, 256);
    };

    const uint64_t kdesc = desc_sw128(sk + w * 64 * 128, 16, 1024);
    const uint64_t vdesc = desc_sw128(sv + w * 64 * 128, 16, 1024);
    const int r0 = n0 + w * 64 + warp * 16 + g;
    const bool valid[2] = {key_valid(p, r0), key_valid(p, r0 + 8)};
    float dk[32], dv[32], s[32], dp[32];
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      mbar_wait(full(st), (j / STAGES) & 1);
      bar_sync(my_bar, 256);
      wgmma_fence();
      issue_scores(s, dp, kdesc, vdesc, sq + st * QT_BYTES, sdo + st * QT_BYTES);
      wgmma_commit();
      hand_over(false);
      wgmma_wait<0>();
      keep(s);
      keep(dp);
      probs_tile(pa, dsa, s, dp, lse_s + st * BQ, dl_s + st * BQ, valid, p, t);
      bar_sync(my_bar, 256);
      wgmma_fence();
      issue_grads(dv, dk, pa, dsa, sq + st * QT_BYTES, sdo + st * QT_BYTES);
      wgmma_commit();
      hand_over(j == n_tiles - 1);
      wgmma_wait<0>();
      keep(dv);
      keep(dk);
      keep(pa);
      keep(dsa);
      mbar_arrive(empty(st));
    }

    store_rows(dkb, p.dk_ss, dk, r0, p.S_k, t);
    store_rows(dvb, p.dv_ss, dv, r0, p.S_k, t);
  }
}

}  // namespace

// q, k, v, dout, dk, dv: [B, H, S, 64] bf16 addressed by element strides (the
// last dim contiguous, every stride a multiple of 8, 16-byte aligned bases);
// lse, delta: [B, H, S_q] fp32 contiguous. kv_page = 0 selects the plain
// mask. Returns the cudaError_t of the launch, or a negative hopper::ERR_* code.
extern "C" int vp_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv,
                            int B, int H, int S_q, int S_k,
                            long long q_sb, long long q_sh, long long q_ss,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            long long do_sb, long long do_sh, long long do_ss,
                            long long dk_sb, long long dk_sh, long long dk_ss,
                            long long dv_sb, long long dv_sh, long long dv_ss,
                            float scale, int kv_len, int kv_page, void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, B, H, S_q, q_sb, q_sh, q_ss, BQ);
  if (rc == 0) rc = make_map(&tk, k, B, H, S_k, k_sb, k_sh, k_ss, BK);
  if (rc == 0) rc = make_map(&tv, v, B, H, S_k, v_sb, v_sh, v_ss, BK);
  if (rc == 0) rc = make_map(&tdo, dout, B, H, S_q, do_sb, do_sh, do_ss, BQ);
  if (rc == 0)
    rc = check_registers(flash_dkv_wgmma_kernel, NTHREADS, 128, PRODUCER_REGS, CONSUMER_REGS);
  if (rc != 0) return rc;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  p.H = H; p.S_q = S_q; p.S_k = S_k; p.kv_len = kv_len; p.kv_page = kv_page;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S_k + BK - 1) / BK, B * H);
  flash_dkv_wgmma_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}
