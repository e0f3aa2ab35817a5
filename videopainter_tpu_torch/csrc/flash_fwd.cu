// Bidirectional flash-attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces videopainter_tpu/ops/flash_attention.py::_flash_kernel (launched by
// _flash_padded). Same function: softmax(scale * Q K^T, masked) V per
// (batch, head), with an online softmax whose running max, denominator and
// output accumulator are fp32; bf16 operands go to the tensor cores with fp32
// accumulation; `scale` multiplies the fp32 scores; P is rounded to bf16
// before P·V, as the TPU kernel does. Key validity is the TPU kernel's
// _kv_valid: plain mode `col < kv_len`, paged mode
// `(col < S_k) && (col % kv_page < kv_len)`. Masked scores are -1e30 (finite,
// as on the TPU), so a query row whose keys are all masked gets the same
// result as there. Optional per-row logsumexp (natural log) in fp32.
//
// What bounds it on the H100: operations. At the flagship shape (B*H = 96,
// S = 17,776, d = 64) one call is 4*B*H*S^2*d = 7.8 TFLOP, 7.9 ms at the
// 989 TFLOP/s dense bf16 peak, against 0.87 GB of q/k/v/o (0.26 ms at
// 3.35 TB/s). So the design keeps the tensor cores fed and everything else
// off device memory:
//  - one block per (128-row query tile, b*h); 8 warps, 16 query rows each;
//    Q fragments stay in registers for the whole key loop;
//  - key/value tiles of 64 rows stream through shared memory, double
//    buffered with cp.async so the next tile loads while this one computes;
//  - Q K^T and P V run on mma.sync m16n8k16 bf16 -> fp32 (fragments loaded
//    with ldmatrix; V with ldmatrix.trans); the score tile never leaves
//    registers: its accumulator layout is reused as P's operand layout;
//  - softmax in the exp2 domain (scale * log2(e) folded into one multiply,
//    ex2.approx), the key mask applied only on tiles that hold masked keys;
//  - two blocks per SM (launch bounds cap registers at 128);
//  - ragged tails need no padding: out-of-range rows load as zeros
//    (cp.async zero-fill) and are masked (keys) or not stored (queries).
// Shared rows are padded to 72 bf16 (144 B) so ldmatrix is conflict-free.
// wgmma, TMA and warp specialisation are left for a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;
constexpr int BLOCK_M = 128;
constexpr int BLOCK_N = 64;
constexpr int NWARPS = BLOCK_M / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int STRIDE = D + 8;
constexpr int SMEM_BYTES = (BLOCK_M + 4 * BLOCK_N) * STRIDE * 2;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int H, S_q, S_k, kv_len, kv_page;
  float scale_log2;
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

// Scores of one key tile into the log2 domain, masked when MASK, folded into
// the running row max mx. Full tiles of the plain mode skip the mask: the
// per-element validity test is a large share of the loop's instructions.
template <bool MASK>
__device__ __forceinline__ void scale_mask_max(float (&s)[8][4], float (&mx)[2],
                                               const Params& p, int n0, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * p.scale_log2;
      if (MASK) {
        const int col = n0 + n * 8 + 2 * t + (e & 1);
        const bool valid = p.kv_page
            ? (col < p.S_k && (col % p.kv_page) < p.kv_len)
            : (col < p.kv_len);
        x = valid ? x : MASKED;
      }
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
}

// Two blocks per SM: ptxas caps registers at 128 (a few bytes spill), and
// the second block's loads and softmax overlap the first one's mma.sync.
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BLOCK_M * STRIDE;      // 2 buffers
  __nv_bfloat16* Vs = Ks + 2 * BLOCK_N * STRIDE;  // 2 buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int m0 = blockIdx.x * BLOCK_M;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;

  // Plain mode: keys past kv_len are all masked and contribute exp(-inf) = 0,
  // so the loop stops at the last tile holding a valid key.
  const int kv_end = p.kv_page ? p.S_k : p.kv_len;
  const int n_tiles = (kv_end + BLOCK_N - 1) / BLOCK_N;

  for (int i = tid; i < BLOCK_M * (D / 8); i += NTHREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int row = m0 + r;
    const bool ok = row < p.S_q;
    cp_async16(Qs + r * STRIDE + c, ok ? qb + row * p.q_ss + c : qb, ok);
  }
  auto load_kv = [&](int tile, int buf) {
    const int n0 = tile * BLOCK_N;
    __nv_bfloat16* kd = Ks + buf * BLOCK_N * STRIDE;
    __nv_bfloat16* vd = Vs + buf * BLOCK_N * STRIDE;
    for (int i = tid; i < BLOCK_N * (D / 8); i += NTHREADS) {
      const int r = i >> 3, c = (i & 7) * 8;
      const int row = n0 + r;
      const bool ok = row < p.S_k;
      cp_async16(kd + r * STRIDE + c, ok ? kb + row * p.k_ss + c : kb, ok);
      cp_async16(vd + r * STRIDE + c, ok ? vb + row * p.v_ss + c : vb, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, 4 k-steps over d = 64
  const int wrow = warp * 16;
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int mi = lane >> 3;
    const int row = wrow + (lane & 7) + (mi & 1) * 8;
    const int col = kk * 16 + (mi >> 1) * 8;
    ldmatrix_x4(qf[kk], Qs + row * STRIDE + col);
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {MASKED, MASKED};  // running max (log2 domain) of rows g, g+8
  float l_run[2] = {0.f, 0.f};        // this thread's share of the denominators

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* Kt = Ks + buf * BLOCK_N * STRIDE;
    const __nv_bfloat16* Vt = Vs + buf * BLOCK_N * STRIDE;

    // S = Q K^T: 16 rows x 64 keys per warp (8 n-tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk2 = 0; kk2 < 2; ++kk2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, Kt + (n * 8 + (lane & 7)) * STRIDE + kk2 * 32 + (lane >> 3) * 8);
        mma_bf16(s[n], qf[2 * kk2], bf[0], bf[1]);
        mma_bf16(s[n], qf[2 * kk2 + 1], bf[2], bf[3]);
      }
    }

    // mask, scale into the log2 domain, and the new running max
    const int n0 = j * BLOCK_N;
    float mx[2] = {m_run[0], m_run[1]};
    if (p.kv_page || n0 + BLOCK_N > p.kv_len)
      scale_mask_max<true>(s, mx, p, n0, t);
    else
      scale_mask_max<false>(s, mx, p, n0, t);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(s[n][e] - m_run[e >> 1]);
        s[n][e] = pe;
        l_run[e >> 1] += pe;
      }
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the score registers, V via ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        const int mi = lane >> 3;
        const int row = kk * 16 + (mi & 1) * 8 + (lane & 7);
        const int col = dp * 16 + (mi >> 1) * 8;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, Vt + row * STRIDE + col);
        mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int r0 = m0 + wrow + g, r1 = r0 + 8;
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < p.S_q)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * p.o_ss + col) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < p.S_q)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * p.o_ss + col) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (p.lse != nullptr && t == 0) {
    float* lb = p.lse + static_cast<long long>(bh) * p.S_q;
    if (r0 < p.S_q) lb[r0] = m_run[0] * LN2 + logf(l_run[0]);
    if (r1 < p.S_q) lb[r1] = m_run[1] * LN2 + logf(l_run[1]);
  }
}

}  // namespace

// q, k, v, o: [B, H, S, 64] bf16 addressed by element strides (the last dim
// contiguous, every stride a multiple of 8); lse: [B, H, S_q] fp32 or null.
// kv_page = 0 selects the plain mask. Returns the cudaError_t of the launch.
extern "C" int vp_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int H, int S_q, int S_k,
                            long long q_sb, long long q_sh, long long q_ss,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            long long o_sb, long long o_sh, long long o_ss,
                            float scale, int kv_len, int kv_page, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.H = H; p.S_q = S_q; p.S_k = S_k; p.kv_len = kv_len; p.kv_page = kv_page;
  p.scale_log2 = scale * LOG2E;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S_q + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
