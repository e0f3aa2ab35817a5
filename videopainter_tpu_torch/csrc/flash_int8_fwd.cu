// int8 (SageAttention-style) flash-attention forward for Hopper (sm_90a).
//
// Replaces videopainter_tpu/ops/flash_attention_int8.py::_int8_flash_kernel
// (launched by _int8_flash_padded) and, through a second entry point, its
// precursor tools/bench_int8_attn.py::_int8_kernel. Same function per
// (batch, head): int8 Q . int8 K^T on the tensor cores with int32
// accumulation; the int32 scores are converted to fp32 and dequantized once by
// sm_scale * sq[q-block] * sk[k-block] (one scalar in the uniform entry);
// keys are masked (plain `col < kv_len`, or paged
// `(col < S_k) && (col % kv_page < kv_len)`, masked scores the finite -1e30);
// online softmax with fp32 running max, denominator and accumulator; then
// either P (rounded to bf16) . V (bf16) with fp32 accumulation, or, in the
// int8 P.V mode, round(P * 127) as int8 times int8 V with int32 accumulation,
// scaled by sv[k-block] / 127 (1 / 127 in the uniform entry); the final
// division by the denominator; bf16 output.
//
// The quantization blocks (blk_q rows share sq, blk_k keys share sk and sv)
// are numerics and come from the caller; the kernel's own tiles (128 query
// rows, 64 keys) must divide them, so one sq holds per query tile and one
// sk / sv per key tile. In the int8 P.V mode P is rounded against the running
// max at each 64-key tile, not at each blk_k block as on the TPU, so the
// rounded P may differ there in its last bit.
//
// What bounds it on the H100: operations. At the flagship shape (B*H = 96,
// 17,776 queries and keys, d = 64) Q.K^T is 3.9 TOP (2.0 ms at the 1,979 TOP/s
// int8 peak) and P.V 3.9 TFLOP in bf16 (3.9 ms at 989 TFLOP/s) or 2.0 ms in
// int8, against 0.6 GB of operands (0.2 ms at 3.35 TB/s). The design is the
// bf16 kernel's (flash_fwd.cu), with the score product on the int8 path:
//  - one block per (128-row query tile, b*h); 8 warps, 16 query rows each; the
//    int8 Q fragments (8 registers) stay in registers for the whole key loop;
//  - K (int8) and V tiles of 64 keys stream through shared memory, double
//    buffered with cp.async;
//  - Q.K^T on mma.sync m16n8k32 s8.s8 -> s32, fragments loaded with ldmatrix
//    (a b16 ldmatrix moves 4 consecutive int8 per thread, which is the s8
//    fragment layout); bf16 P.V on m16n8k16 as in flash_fwd.cu;
//  - int8 P.V: V arrives transposed ([d, key], the caller writes it so in its
//    quantization pass), so its B fragments are plain ldmatrix loads. P's A
//    fragment wants 4 consecutive keys per thread where the score accumulator
//    holds 2: the K rows are read in a permuted order (ldmatrix takes any row
//    address), so that the accumulator of two neighbouring 8-key tiles packs
//    into 4 consecutive keys without a shuffle;
//  - the mask is applied only on tiles that hold a masked key, and the key
//    loop stops at the last tile with a valid key (plain mode).
// Shared rows are padded (int8 rows to 80 bytes, bf16 V rows to 144) so that
// ldmatrix is conflict-free. wgmma, TMA and warp specialisation are left for
// a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;
constexpr int BLOCK_M = 128;
constexpr int BLOCK_N = 64;
constexpr int NWARPS = BLOCK_M / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int QSTRIDE = D + 16;        // bytes per int8 Q / K row in shared memory
constexpr int VSTRIDE = D + 8;         // bf16 elements per V row
constexpr int VTSTRIDE = BLOCK_N + 16; // bytes per int8 V^T row ([d][key])
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// bytes of one V tile and of the block's shared memory, by P.V mode
template <bool PV>
struct Tile {
  static constexpr int V_BYTES = PV ? D * VTSTRIDE : BLOCK_N * VSTRIDE * 2;
  static constexpr int SMEM_BYTES = BLOCK_M * QSTRIDE + 2 * BLOCK_N * QSTRIDE + 2 * V_BYTES;
};

struct Params {
  const int8_t* q;
  const int8_t* k;
  const void* v;        // bf16 [B, H, S_k, 64], or int8 V^T [B, H, 64, S_k padded]
  __nv_bfloat16* o;
  const float* sq;      // [B*H, nq], or null: uniform dequantization
  const float* sk;      // [B*H, nk]
  const float* sv;      // [B*H, nk] (int8 P.V mode)
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int H, S_q, S_k, kv_len, kv_page, blk_q, blk_k, nq, nk;
  float sm_scale, deq_uniform;
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

// c[16x8] += a[16x32] * b[32x8], int8 operands, int32 accumulator
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// round(p * 127) of four probabilities in [0, 1] (half to even) as 4 int8
__device__ __forceinline__ uint32_t pack_p8(float p0, float p1, float p2, float p3) {
  const uint32_t a = static_cast<uint32_t>(__float2int_rn(p0 * 127.f));
  const uint32_t b = static_cast<uint32_t>(__float2int_rn(p1 * 127.f));
  const uint32_t c = static_cast<uint32_t>(__float2int_rn(p2 * 127.f));
  const uint32_t d = static_cast<uint32_t>(__float2int_rn(p3 * 127.f));
  return a | (b << 8) | (c << 16) | (d << 24);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Which key of the tile sits in row r (0..7) of score tile n (0..7). Plain
// order for bf16 P.V. For int8 P.V, per group of 16 keys the even tile holds
// keys 4i, 4i+1 and the odd tile keys 4i+2, 4i+3 (i = r / 2), so a thread's
// two accumulator columns of both tiles are 4 consecutive keys.
template <bool PV>
__device__ __forceinline__ int tile_key(int n, int r) {
  return PV ? 16 * (n >> 1) + 4 * (r >> 1) + 2 * (n & 1) + (r & 1) : 8 * n + r;
}

// Scores of one key tile: dequantized into the log2 domain by f, masked when
// MASK, folded into the running row max mx.
template <bool MASK, bool PV>
__device__ __forceinline__ void scale_mask_max(float (&s)[8][4], float (&mx)[2],
                                               const Params& p, float f, int n0, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * f;
      if (MASK) {
        const int col = n0 + tile_key<PV>(n, 2 * t + (e & 1));
        const bool valid = p.kv_page
            ? (col < p.S_k && (col % p.kv_page) < p.kv_len)
            : (col < p.kv_len);
        x = valid ? x : MASKED;
      }
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
}

template <bool PV>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_int8_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);
  int8_t* Ks = Qs + BLOCK_M * QSTRIDE;                                  // 2 buffers
  unsigned char* Vs = reinterpret_cast<unsigned char*>(Ks + 2 * BLOCK_N * QSTRIDE);  // 2 buffers
  constexpr int VBYTES = Tile<PV>::V_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int m0 = blockIdx.x * BLOCK_M;

  const int8_t* qb = p.q + b * p.q_sb + h * p.q_sh;
  const int8_t* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb16 = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int8_t* vb8 = static_cast<const int8_t*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;

  // Plain mode: keys past kv_len are all masked and contribute exp(-inf) = 0,
  // so the loop stops at the last tile holding a valid key.
  const int kv_end = p.kv_page ? p.S_k : p.kv_len;
  const int n_tiles = (kv_end + BLOCK_N - 1) / BLOCK_N;

  for (int i = tid; i < BLOCK_M * (D / 16); i += NTHREADS) {
    const int r = i >> 2, c = (i & 3) * 16;
    const int row = m0 + r;
    const bool ok = row < p.S_q;
    cp_async16(Qs + r * QSTRIDE + c, ok ? qb + row * p.q_ss + c : qb, ok);
  }
  auto load_kv = [&](int tile, int buf) {
    const int n0 = tile * BLOCK_N;
    int8_t* kd = Ks + buf * BLOCK_N * QSTRIDE;
    for (int i = tid; i < BLOCK_N * (D / 16); i += NTHREADS) {
      const int r = i >> 2, c = (i & 3) * 16;
      const int row = n0 + r;
      const bool ok = row < p.S_k;
      cp_async16(kd + r * QSTRIDE + c, ok ? kb + row * p.k_ss + c : kb, ok);
    }
    if (PV) {
      // V^T: 64 d-rows of 64 key bytes; the caller pads the key axis with
      // zeros to a multiple of the tile, so every chunk is in range
      int8_t* vd = reinterpret_cast<int8_t*>(Vs + buf * VBYTES);
      for (int i = tid; i < D * (BLOCK_N / 16); i += NTHREADS) {
        const int r = i >> 2, c = (i & 3) * 16;
        cp_async16(vd + r * VTSTRIDE + c, vb8 + r * p.v_ss + n0 + c, true);
      }
    } else {
      __nv_bfloat16* vd = reinterpret_cast<__nv_bfloat16*>(Vs + buf * VBYTES);
      for (int i = tid; i < BLOCK_N * (D / 8); i += NTHREADS) {
        const int r = i >> 3, c = (i & 7) * 8;
        const int row = n0 + r;
        const bool ok = row < p.S_k;
        cp_async16(vd + r * VSTRIDE + c, ok ? vb16 + row * p.v_ss + c : vb16, ok);
      }
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as s8 mma A fragments, 2 k-steps over d = 64
  const int wrow = warp * 16;
  uint32_t qf[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int mi = lane >> 3;
    const int row = wrow + (lane & 7) + (mi & 1) * 8;
    ldmatrix_x4(qf[kk], Qs + row * QSTRIDE + kk * 32 + (mi >> 1) * 16);
  }

  const bool uniform = p.sq == nullptr;
  const float sq = uniform ? 1.f : p.sq[static_cast<long long>(bh) * p.nq + m0 / p.blk_q];

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

    const int8_t* Kt = Ks + buf * BLOCK_N * QSTRIDE;
    const int n0 = j * BLOCK_N;
    const long long kblk = static_cast<long long>(bh) * p.nk + n0 / p.blk_k;
    // the scale product applied once, in fp32, as the TPU kernel does
    const float f = (uniform ? p.sm_scale * p.deq_uniform
                             : p.sm_scale * (sq * p.sk[kblk])) * LOG2E;

    // S = Q K^T in int32: 16 rows x 64 keys per warp (8 tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      int si[4] = {0, 0, 0, 0};
      uint32_t bf[4];
      ldmatrix_x4(bf, Kt + tile_key<PV>(n, lane & 7) * QSTRIDE + (lane >> 3) * 16);
      mma_s8(si, qf[0], bf[0], bf[1]);
      mma_s8(si, qf[1], bf[2], bf[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = static_cast<float>(si[e]);
    }

    // dequantize into the log2 domain, mask, and the new running max
    float mx[2] = {m_run[0], m_run[1]};
    if (p.kv_page || n0 + BLOCK_N > p.kv_len)
      scale_mask_max<true, PV>(s, mx, p, f, n0, t);
    else
      scale_mask_max<false, PV>(s, mx, p, f, n0, t);
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

    if (PV) {
      // O += round(P * 127) V_int8 * sv / 127, the product in int32
      const int8_t* Vt = reinterpret_cast<const int8_t*>(Vs + buf * VBYTES);
      const float dpv = (uniform ? 1.f : p.sv[kblk]) * (1.f / 127.f);
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int n = 4 * kk;
        pa[kk][0] = pack_p8(s[n][0], s[n][1], s[n + 1][0], s[n + 1][1]);
        pa[kk][1] = pack_p8(s[n][2], s[n][3], s[n + 1][2], s[n + 1][3]);
        pa[kk][2] = pack_p8(s[n + 2][0], s[n + 2][1], s[n + 3][0], s[n + 3][1]);
        pa[kk][3] = pack_p8(s[n + 2][2], s[n + 2][3], s[n + 3][2], s[n + 3][3]);
      }
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        int c[4] = {0, 0, 0, 0};
        uint32_t bf[4];
        ldmatrix_x4(bf, Vt + (dn * 8 + (lane & 7)) * VTSTRIDE + (lane >> 3) * 16);
        mma_s8(c, pa[0], bf[0], bf[1]);
        mma_s8(c, pa[1], bf[2], bf[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dn][e] += static_cast<float>(c[e]) * dpv;
      }
    } else {
      // O += P V: P (bf16) from the score registers, V via ldmatrix.trans
      const __nv_bfloat16* Vt = reinterpret_cast<const __nv_bfloat16*>(Vs + buf * VBYTES);
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
          ldmatrix_x4_trans(bf, Vt + row * VSTRIDE + col);
          mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
          mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
        }
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
}

int launch(const Params& p, int B, bool int8_pv, void* stream) {
  if (p.blk_q % BLOCK_M != 0 || p.blk_k % BLOCK_N != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((p.S_q + BLOCK_M - 1) / BLOCK_M, B * p.H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_pv) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_int8_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<true>::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_int8_kernel<true><<<grid, NTHREADS, Tile<true>::SMEM_BYTES, st>>>(p);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        flash_int8_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<false>::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_int8_kernel<false><<<grid, NTHREADS, Tile<false>::SMEM_BYTES, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k: int8 [B, H, S, 64] addressed by element strides (last dim contiguous,
// every stride a multiple of 16). v: bf16 [B, H, S_k, 64] (strides multiples
// of 8), or with int8_pv the transposed int8 V^T [B, H, 64, S_k padded with
// zeros to a multiple of 64] (v_ss = the row stride of V^T). o: bf16
// [B, H, S_q, 64] by strides. sq [B*H, nq], sk and sv [B*H, nk] fp32, one
// scale per blk_q rows / blk_k keys; blk_q % 128 == 0 and blk_k % 64 == 0.
// kv_page = 0 selects the plain mask. Returns the cudaError_t of the launch.
extern "C" int vp_flash_int8_fwd(const void* q, const void* k, const void* v, void* o,
                                 const void* sq, const void* sk, const void* sv,
                                 int B, int H, int S_q, int S_k,
                                 long long q_sb, long long q_sh, long long q_ss,
                                 long long k_sb, long long k_sh, long long k_ss,
                                 long long v_sb, long long v_sh, long long v_ss,
                                 long long o_sb, long long o_sh, long long o_ss,
                                 float sm_scale, int kv_len, int kv_page,
                                 int blk_q, int blk_k, int int8_pv, void* stream) {
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = v;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.sq = static_cast<const float*>(sq);
  p.sk = static_cast<const float*>(sk);
  p.sv = static_cast<const float*>(sv);
  if (p.sq == nullptr || p.sk == nullptr || (int8_pv && p.sv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.H = H; p.S_q = S_q; p.S_k = S_k; p.kv_len = kv_len; p.kv_page = kv_page;
  p.blk_q = blk_q; p.blk_k = blk_k;
  p.nq = (S_q + blk_q - 1) / blk_q; p.nk = (S_k + blk_k - 1) / blk_k;
  p.sm_scale = sm_scale; p.deq_uniform = 1.f;
  return launch(p, B, int8_pv != 0, stream);
}

// The precursor: one scalar deq_scale for every score, the plain kv_len mask,
// P.V in bf16 or (int8_pv) in int8 scaled by 1 / 127. Same layouts as above.
extern "C" int vp_flash_int8_uniform_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int H, int S_q, int S_k,
                                         long long q_sb, long long q_sh, long long q_ss,
                                         long long k_sb, long long k_sh, long long k_ss,
                                         long long v_sb, long long v_sh, long long v_ss,
                                         long long o_sb, long long o_sh, long long o_ss,
                                         float sm_scale, float deq_scale, int kv_len,
                                         int int8_pv, void* stream) {
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = v;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.sq = nullptr; p.sk = nullptr; p.sv = nullptr;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.H = H; p.S_q = S_q; p.S_k = S_k; p.kv_len = kv_len; p.kv_page = 0;
  p.blk_q = BLOCK_M; p.blk_k = BLOCK_N; p.nq = 1; p.nk = 1;
  p.sm_scale = sm_scale; p.deq_uniform = deq_scale;
  return launch(p, B, int8_pv != 0, stream);
}
