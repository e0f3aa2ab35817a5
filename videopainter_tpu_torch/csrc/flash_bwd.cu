// Bidirectional flash-attention backward for Hopper (sm_90a), bf16 in/out:
// two kernels, dQ and dK/dV, with no atomics (gradients are deterministic).
//
// Replaces videopainter_tpu/ops/flash_attention.py::_flash_dq_kernel and
// ::_flash_dkv_kernel (launched by _flash_bwd_padded). Same functions: with
// the forward's per-row logsumexp `lse` and delta = rowsum(dO * O),
//   P  = exp(scale * Q K^T - lse) under the key mask (masked keys: exactly 0),
//   dP = dO V^T,   dS = P * (dP - delta) * scale,
//   dQ = dS K,     dV = P^T dO,     dK = dS^T Q,
// bf16 operands on the tensor cores with fp32 accumulation, `scale` applied to
// the fp32 scores, P rounded to bf16 before P^T dO and dS rounded to bf16
// before its products, as the TPU kernels do. P is recomputed the way the
// forward kernel made it: exp2 of scores in the log2 domain against lse *
// log2(e). Key validity is _kv_valid: plain `col < kv_len`, paged
// `(col < S_k) && (col % kv_page < kv_len)`.
//
// The TPU kernels transpose the scores and take lse / delta in 8 redundant
// sublane copies; both are Mosaic layout rules with no counterpart here: lse
// and delta are plain [B, H, S_q] fp32, and each kernel picks the orientation
// that keeps its accumulator rows in the warp that owns them.
//
// What bounds them on the H100: operations. At [48, 17,776, 64] dQ is
// 6*B*H*S_q*S_k*d = 5.8 TFLOP (5.89 ms at the 989 TFLOP/s dense bf16 peak),
// dK/dV 8*B*H*S_q*S_k*d = 7.8 TFLOP (7.85 ms), against 0.5 GB of operands
// (0.16 ms at 3.35 TB/s). So, as in the forward kernel, scores and
// probabilities never leave registers and tiles are loaded once per block:
//  - dQ: one block per (128 query rows, b*h), 8 warps of 16 rows. Q and dO
//    fragments stay in registers; 64-key K / V tiles stream through shared
//    memory (cp.async, double buffered). Per tile: S = Q K^T and dP = dO V^T
//    (mma.sync m16n8k16, ldmatrix), dS packed from the accumulator layout
//    straight into the A operand of dQ += dS K (K via ldmatrix.trans);
//  - dK/dV: one block per (128 keys, b*h), 8 warps of 16 keys. K and V
//    fragments stay in registers; 64-row Q / dO tiles (and their lse / delta)
//    stream through shared memory. Per tile the transposed scores
//    S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with
//    dO and Q via ldmatrix.trans. In plain mode a block whose keys are all
//    masked writes zeros and returns;
//  - ragged tails need no padding: out-of-range rows load as zeros
//    (cp.async zero-fill), out-of-range queries get lse = +1e30 so their P is
//    exactly 0, masked keys get P = 0, and no row past S_q / S_k is stored.
// dQ runs two blocks per SM (launch bounds cap it at 128 registers; it needs
// 123 and spills nothing), which took it from 37 to 22 ms at [48, 17,776, 64].
// dK/dV holds two accumulators and two packed score tiles and runs one block
// per SM on the whole register file: capped at 128 registers it spills and is
// no faster. wgmma, TMA and warp specialisation are left for a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;
constexpr int BLOCK_ROWS = 128;   // rows a block owns (queries in dQ, keys in dK/dV)
constexpr int BLOCK_STREAM = 64;  // rows of a streamed tile
constexpr int NWARPS = BLOCK_ROWS / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int STRIDE = D + 8;     // padded shared rows: conflict-free ldmatrix
constexpr int TILE_BYTES = (2 * BLOCK_ROWS + 4 * BLOCK_STREAM) * STRIDE * 2;
constexpr int DQ_SMEM = TILE_BYTES;
constexpr int DKV_SMEM = TILE_BYTES + 4 * BLOCK_STREAM * 4;  // + lse, delta x 2 buffers
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NO_ROW = 1e30f;   // lse of an out-of-range query: P = exp2(-1e30) = 0

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, H, S_q]
  const float* delta;  // [B, H, S_q]
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int H, S_q, S_k, kv_len, kv_page;
  float scale, scale_log2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool key_valid(const Params& p, int col) {
  return p.kv_page ? (col < p.S_k && (col % p.kv_page) < p.kv_len) : (col < p.kv_len);
}

// rows [row0, row0 + rows) of a [S, 64] operand into padded shared rows;
// rows from `limit` on are zero-filled
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long stride, int row0, int rows, int limit,
                                          int tid) {
  for (int i = tid; i < rows * (D / 8); i += NTHREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int row = row0 + r;
    const bool ok = row < limit;
    cp_async16(dst + r * STRIDE + c, ok ? base + row * stride + c : base, ok);
  }
}

// this warp's 16 rows of a shared tile as mma A fragments, 4 k-steps over d = 64
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[4][4], const __nv_bfloat16* tile,
                                             int wrow, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int mi = lane >> 3;
    const int row = wrow + (lane & 7) + (mi & 1) * 8;
    const int col = kk * 16 + (mi >> 1) * 8;
    ldmatrix_x4(f[kk], tile + row * STRIDE + col);
  }
}

// c[16 x 8] = A[16 x 64] * T[8 rows n*8.. of a streamed tile]^T
__device__ __forceinline__ void mma_nt(float (&c)[4], const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* tile, int n, int lane) {
#pragma unroll
  for (int kk2 = 0; kk2 < 2; ++kk2) {
    uint32_t bf[4];
    ldmatrix_x4(bf, tile + (n * 8 + (lane & 7)) * STRIDE + kk2 * 32 + (lane >> 3) * 8);
    mma_bf16(c, a[2 * kk2], bf[0], bf[1]);
    mma_bf16(c, a[2 * kk2 + 1], bf[2], bf[3]);
  }
}

// acc[16 x 64] += A[16 x 64 (streamed rows)] * T[64 rows x 64], A packed from
// an accumulator layout, T via ldmatrix.trans
__device__ __forceinline__ void mma_nn(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      const int mi = lane >> 3;
      const int row = kk * 16 + (mi & 1) * 8 + (lane & 7);
      const int col = dp * 16 + (mi >> 1) * 8;
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, tile + row * STRIDE + col);
      mma_bf16(acc[2 * dp], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// the warp's 16 x 64 fp32 accumulator to rows r0 = row_base + g and r0 + 8
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long stride,
                                           const float (&acc)[8][4], int r0, int limit,
                                           int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(base + r0 * stride + col) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (r1 < limit)
      *reinterpret_cast<__nv_bfloat162*>(base + r1 * stride + col) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// Two blocks per SM: the second block's loads and exp2 overlap the first
// one's mma.sync.
__global__ void __launch_bounds__(NTHREADS, 2)
flash_dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BLOCK_ROWS * STRIDE;
  __nv_bfloat16* Ks = dOs + BLOCK_ROWS * STRIDE;       // 2 buffers
  __nv_bfloat16* Vs = Ks + 2 * BLOCK_STREAM * STRIDE;  // 2 buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int m0 = blockIdx.x * BLOCK_ROWS;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;

  // plain mode: keys past kv_len have P = 0, so the loop stops at kv_len
  const int kv_end = p.kv_page ? p.S_k : p.kv_len;
  const int n_tiles = (kv_end + BLOCK_STREAM - 1) / BLOCK_STREAM;

  load_rows(Qs, qb, p.q_ss, m0, BLOCK_ROWS, p.S_q, tid);
  load_rows(dOs, dob, p.do_ss, m0, BLOCK_ROWS, p.S_q, tid);
  auto load_kv = [&](int tile, int buf) {
    load_rows(Ks + buf * BLOCK_STREAM * STRIDE, kb, p.k_ss, tile * BLOCK_STREAM,
              BLOCK_STREAM, p.S_k, tid);
    load_rows(Vs + buf * BLOCK_STREAM * STRIDE, vb, p.v_ss, tile * BLOCK_STREAM,
              BLOCK_STREAM, p.S_k, tid);
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wrow = warp * 16;
  uint32_t qf[4][4], dof[4][4];
  load_a_frags(qf, Qs, wrow, lane);
  load_a_frags(dof, dOs, wrow, lane);

  const int r0 = m0 + wrow + g, r1 = r0 + 8;
  const float* lse_b = p.lse + static_cast<long long>(bh) * p.S_q;
  const float* dl_b = p.delta + static_cast<long long>(bh) * p.S_q;
  const float lse2[2] = {r0 < p.S_q ? lse_b[r0] * LOG2E : NO_ROW,
                         r1 < p.S_q ? lse_b[r1] * LOG2E : NO_ROW};
  const float dl[2] = {r0 < p.S_q ? dl_b[r0] : 0.f, r1 < p.S_q ? dl_b[r1] : 0.f};

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* Kt = Ks + buf * BLOCK_STREAM * STRIDE;
    const __nv_bfloat16* Vt = Vs + buf * BLOCK_STREAM * STRIDE;
    const int n0 = j * BLOCK_STREAM;
    const bool mask_tile = p.kv_page || n0 + BLOCK_STREAM > p.kv_len;

    uint32_t dsa[4][4];  // dS (16 queries x 64 keys) as A fragments
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_nt(s, qf, Kt, n, lane);
      mma_nt(dp, dof, Vt, n, lane);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(s[e] * p.scale_log2 - lse2[e >> 1]);
        if (mask_tile && !key_valid(p, n0 + n * 8 + 2 * t + (e & 1))) pe = 0.f;
        ds[e] = pe * (dp[e] - dl[e >> 1]) * p.scale;
      }
      dsa[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_nn(acc, dsa, Kt, lane);  // dQ += dS K
    __syncthreads();             // this buffer is refilled two iterations on
  }

  store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, acc, r0, p.S_q, t);
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BLOCK_ROWS * STRIDE;
  __nv_bfloat16* Qs = Vs + BLOCK_ROWS * STRIDE;         // 2 buffers
  __nv_bfloat16* dOs = Qs + 2 * BLOCK_STREAM * STRIDE;  // 2 buffers
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BLOCK_STREAM * STRIDE);  // 2 buffers
  float* dl_s = lse_s + 2 * BLOCK_STREAM;                                    // 2 buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.x * BLOCK_ROWS;
  const int wrow = warp * 16;
  const int r0 = n0 + wrow + g, r1 = r0 + 8;

  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + h * p.dv_sh;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // plain mode: a block past kv_len holds masked keys only; their rows are 0
  if (!p.kv_page && n0 >= p.kv_len) {
    store_rows(dkb, p.dk_ss, dk, r0, p.S_k, t);
    store_rows(dvb, p.dv_ss, dv, r0, p.S_k, t);
    return;
  }

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lse_b = p.lse + static_cast<long long>(bh) * p.S_q;
  const float* dl_b = p.delta + static_cast<long long>(bh) * p.S_q;
  const int n_tiles = (p.S_q + BLOCK_STREAM - 1) / BLOCK_STREAM;

  load_rows(Ks, kb, p.k_ss, n0, BLOCK_ROWS, p.S_k, tid);
  load_rows(Vs, vb, p.v_ss, n0, BLOCK_ROWS, p.S_k, tid);
  auto load_q = [&](int tile, int buf) {
    const int m0 = tile * BLOCK_STREAM;
    load_rows(Qs + buf * BLOCK_STREAM * STRIDE, qb, p.q_ss, m0, BLOCK_STREAM, p.S_q, tid);
    load_rows(dOs + buf * BLOCK_STREAM * STRIDE, dob, p.do_ss, m0, BLOCK_STREAM, p.S_q, tid);
    if (tid < 2 * BLOCK_STREAM) {  // lse (log2 domain) and delta of the tile's queries
      const int i = tid & (BLOCK_STREAM - 1);
      const int row = m0 + i;
      if (tid < BLOCK_STREAM)
        lse_s[buf * BLOCK_STREAM + i] = row < p.S_q ? lse_b[row] * LOG2E : NO_ROW;
      else
        dl_s[buf * BLOCK_STREAM + i] = row < p.S_q ? dl_b[row] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, Ks, wrow, lane);
  load_a_frags(vf, Vs, wrow, lane);
  const bool valid[2] = {key_valid(p, r0), key_valid(p, r1)};

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_q(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* Qt = Qs + buf * BLOCK_STREAM * STRIDE;
    const __nv_bfloat16* dOt = dOs + buf * BLOCK_STREAM * STRIDE;
    const float* lse_t = lse_s + buf * BLOCK_STREAM;
    const float* dl_t = dl_s + buf * BLOCK_STREAM;

    uint32_t pa[4][4], dsa[4][4];  // P^T and dS^T (16 keys x 64 queries) as A fragments
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_nt(s, kf, Qt, n, lane);     // S^T = K Q^T
      mma_nt(dp, vf, dOt, n, lane);   // dP^T = V dO^T
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + n * 8 + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_t + n * 8 + 2 * t);
      float pe[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l2.y : l2.x;
        const float d = (e & 1) ? d2.y : d2.x;
        pe[e] = valid[e >> 1] ? ex2(s[e] * p.scale_log2 - l) : 0.f;
        ds[e] = pe[e] * (dp[e] - d) * p.scale;
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(pe[0], pe[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
      dsa[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_nn(dv, pa, dOt, lane);   // dV += P^T dO
    mma_nn(dk, dsa, Qt, lane);   // dK += dS^T Q
    __syncthreads();             // this buffer is refilled two iterations on
  }

  store_rows(dkb, p.dk_ss, dk, r0, p.S_k, t);
  store_rows(dvb, p.dv_ss, dv, r0, p.S_k, t);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, int H, int S_q, int S_k,
                   const long long* st, float scale, int kv_len, int kv_page) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_ss = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_ss = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_ss = st[8];
  p.do_sb = st[9]; p.do_sh = st[10]; p.do_ss = st[11];
  p.dq_sb = p.dq_sh = p.dq_ss = p.dk_sb = p.dk_sh = p.dk_ss = 0;
  p.dv_sb = p.dv_sh = p.dv_ss = 0;
  p.H = H; p.S_q = S_q; p.S_k = S_k; p.kv_len = kv_len; p.kv_page = kv_page;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  return p;
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [B, H, S, 64] bf16 addressed by element strides
// (the last dim contiguous, every stride a multiple of 8); lse, delta:
// [B, H, S_q] fp32 contiguous. kv_page = 0 selects the plain mask. Both return
// the cudaError_t of the launch.
extern "C" int vp_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq,
                           int B, int H, int S_q, int S_k,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long do_sb, long long do_sh, long long do_ss,
                           long long dq_sb, long long dq_sh, long long dq_ss,
                           float scale, int kv_len, int kv_page, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  Params p = make_params(q, k, v, dout, lse, delta, H, S_q, S_k, st, scale, kv_len, kv_page);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S_q + BLOCK_ROWS - 1) / BLOCK_ROWS, B * H);
  flash_dq_kernel<<<grid, NTHREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

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
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  Params p = make_params(q, k, v, dout, lse, delta, H, S_q, S_k, st, scale, kv_len, kv_page);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S_k + BLOCK_ROWS - 1) / BLOCK_ROWS, B * H);
  flash_dkv_kernel<<<grid, NTHREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
