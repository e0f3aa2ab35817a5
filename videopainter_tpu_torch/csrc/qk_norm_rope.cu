// Attention's prep for Hopper (sm_90a): the per-head QK LayerNorm and the
// interleaved RoPE on the video rows, in one pass, forward and backward.
//
// It replaces no Pallas kernel: the JAX package leaves this prep to XLA's
// fusion (videopainter_tpu/ops/attention.py, `layer_norm` on q and k and
// `_rope_video_slice`). On the card it was a chain of eager passes (an fp32
// copy, the layer norm over rows of 64, a cast back, an fp32 copy, the rotated
// pairs stacked, two multiplies, an add, a cast, slice copies): about 88 bytes
// moved a value of q and of k. Contract:
//   x   : q or k projection [B, S, H * 64] with any batch and token strides,
//         the last dim contiguous (a `to_qkv(x).chunk(3)` view); bf16 or fp32
//   y   : [B, S, H, 64] contiguous, x's dtype
//   rows s < text_len: y = LN(x) (affine, rounded to x's dtype)
//   rows s >= text_len: y = rope(LN(x) rounded) rounded, with the fp32 tables
//         cos / sin [S - text_len, 64] (interleaved pairs: (a, b) ->
//         (a c - b s, b c + a s)), the arithmetic of ops/rope.py
//         `apply_rotary_emb` op for op, so it rounds where that does
// LN: two-pass fp32 mean and variance over the 64 values, rstd = rsqrt(var +
// eps), then the affine in fp32 (the weights' own dtype, fp32 or bf16, read as
// fp32): ops/basic.py `layer_norm`'s statistics and affine. One launch covers
// q and k (tensors 0 and 1), each with its own weights; no norm (or no rope)
// leaves that step out.
//
// What bounds it on the H100: bytes. It has to read a value once and write it
// once: 4 B a bf16 value. A served call (q and k [2, 17,776, 48, 64]) moves
// 874 MB, 0.261 ms at 3.35 TB/s. The design meets that bound so:
//  - a row of 64 values (one head of one token) is one group of 8 threads,
//    each holding 8 values from one 16-byte load (two for fp32); the group's
//    sums are three xor shuffles, so no shared memory and no barrier;
//  - a warp's unit of work is one (token, tensor, batch) item: its 4 groups
//    walk the H heads, 4 rows at a time, and issue the loads of UNROLL
//    iterations before any reduction, so enough bytes are in flight to cover
//    the memory's latency;
//  - the token's cos / sin row (64 + 64 fp32) is read once an item and kept in
//    registers for all its heads; the pairs are neighbours inside a thread's 8
//    values, so the rotation needs no shuffle;
//  - the grid walks the items with a stride, sized by the caller to a few
//    blocks an SM.
// The backward reads x, dy, the saved fp32 mean and rstd (8 B a row), and
// writes dx: the transposed rotation dn = (dy_a c_a + dy_b s_b, dy_b c_b -
// dy_a s_a) on video rows (dn = dy on text rows), then the LayerNorm backward
// in fp32, dx = rstd (g - mean(g) - xhat mean(g xhat)) with g = dn w. Where the
// caller asks for them, dw = sum dn xhat and db = sum dn are kept per thread
// in registers over all the rows it visits, then summed over the block and
// written as one fp32 row of 64 a block; the caller ends the sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head width
constexpr int VEC = 8;         // values a thread
constexpr int GROUP = D / VEC; // threads a row
constexpr int ROWS = 32 / GROUP;   // rows a warp at once
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FWD_UNROLL = 4;
constexpr int BWD_UNROLL = 2;

struct Side {            // one of q, k
  const void* x;         // [B, S, H * 64]
  long long xb, xs;      // its batch and token strides (elements)
  void* y;               // forward: [B, S, H, 64]
  const void* dy;        // backward: the output's gradient
  long long db, ds, dh;  // its batch, token and head strides (elements)
  void* dx;              // backward: [B, S, H * 64] contiguous
  const void* w;         // affine weight [64] or null
  const void* b;         // affine bias [64] or null
  float* mean;           // [B, S, H]; forward: written where not null
  float* rstd;
  float* dw;             // backward: [gridDim.x, 64] partials, or null
  float* dbias;
  int norm;              // 0: no LayerNorm on this tensor
  float eps;
};

struct Params {
  Side t0, t1;
  int nt, batch, seq, heads, text_len;
  const float* cos;      // [seq - text_len, 64] or null (no rope)
  const float* sin;
  int params_bf16;       // weights and biases are bf16 (else fp32)
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float v[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// A value rounded to the storage type T and read back as fp32.
template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

// A weight or bias row's 8 values of this thread: `fill` where absent.
__device__ __forceinline__ void load_param(const void* p, int col, int bf16, float fill,
                                           float v[VEC]) {
  if (p == nullptr) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = fill;
  } else if (bf16) {
    load8(static_cast<const __nv_bfloat16*>(p) + col, v);
  } else {
    load8(static_cast<const float*>(p) + col, v);
  }
}

// Sum over the 8 threads of a row (lanes 8g .. 8g + 7).
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

__device__ __forceinline__ bool wants_dparams(const Side& sd) {
  return sd.norm && (sd.dw != nullptr || sd.dbias != nullptr);
}

struct Item {
  int s, t, b;
};

__device__ __forceinline__ Item decode(int item, const Params& p) {
  const int per_token = p.nt * p.batch;
  Item it;
  it.s = item / per_token;
  const int tb = item - it.s * per_token;
  it.t = tb / p.batch;
  it.b = tb - it.t * p.batch;
  return it;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
qk_norm_rope_fwd_kernel(const __grid_constant__ Params p) {
  const int lane = threadIdx.x & 31;
  const int grp = lane / GROUP;
  const int col = (lane % GROUP) * VEC;
  const int items = p.seq * p.nt * p.batch;
  const int iters = (p.heads + ROWS - 1) / ROWS;
  for (int item = blockIdx.x * WARPS + threadIdx.x / 32; item < items;
       item += gridDim.x * WARPS) {
    const Item it = decode(item, p);
    const Side& sd = it.t ? p.t1 : p.t0;
    const bool rot = p.cos != nullptr && it.s >= p.text_len;
    float c[VEC], sn[VEC], w[VEC], bias[VEC];
    if (rot) {
      load8(p.cos + static_cast<long long>(it.s - p.text_len) * D + col, c);
      load8(p.sin + static_cast<long long>(it.s - p.text_len) * D + col, sn);
    }
    if (sd.norm) {
      load_param(sd.w, col, p.params_bf16, 1.f, w);
      load_param(sd.b, col, p.params_bf16, 0.f, bias);
    }
    const T* x = static_cast<const T*>(sd.x) + it.b * sd.xb + it.s * sd.xs + col;
    const long long row0 = (static_cast<long long>(it.b) * p.seq + it.s) * p.heads;
    T* y = static_cast<T*>(sd.y) + row0 * D + col;
    for (int i0 = 0; i0 < iters; i0 += FWD_UNROLL) {
      float v[FWD_UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < FWD_UNROLL; ++u) {
        const int h = (i0 + u) * ROWS + grp;
        if (h < p.heads) {
          load8(x + h * D, v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < FWD_UNROLL; ++u) {
        const int h = (i0 + u) * ROWS + grp;
        if (sd.norm) {
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) sum += v[u][j];
          const float mu = group_sum(sum) * (1.f / D);
          float sq = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float d = v[u][j] - mu;
            sq += d * d;
          }
          const float rs = rsqrtf(group_sum(sq) * (1.f / D) + sd.eps);
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            v[u][j] = round_to<T>((v[u][j] - mu) * rs * w[j] + bias[j]);
          if (sd.mean != nullptr && col == 0 && h < p.heads) {
            sd.mean[row0 + h] = mu;
            sd.rstd[row0 + h] = rs;
          }
        }
        if (rot) {
          // x * cos + rotate_pairs(x) * sin, each product and the sum rounded
          // to fp32 as the eager ops round them (no contraction into an FMA)
#pragma unroll
          for (int j = 0; j < VEC; j += 2) {
            const float a = v[u][j], b = v[u][j + 1];
            v[u][j] = __fadd_rn(__fmul_rn(a, c[j]), __fmul_rn(-b, sn[j]));
            v[u][j + 1] = __fadd_rn(__fmul_rn(b, c[j + 1]), __fmul_rn(a, sn[j + 1]));
          }
        }
        if (h < p.heads) store8(y + h * D, v[u]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
qk_norm_rope_bwd_kernel(const __grid_constant__ Params p) {
  const int lane = threadIdx.x & 31;
  const int grp = lane / GROUP;
  const int col = (lane % GROUP) * VEC;
  const int items = p.seq * p.nt * p.batch;
  const int iters = (p.heads + ROWS - 1) / ROWS;
  // this thread's share of dw and db of each tensor, over every row it visits
  float acc_w[2][VEC], acc_b[2][VEC];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc_w[t][j] = acc_b[t][j] = 0.f;

  for (int item = blockIdx.x * WARPS + threadIdx.x / 32; item < items;
       item += gridDim.x * WARPS) {
    const Item it = decode(item, p);
    const Side& sd = it.t ? p.t1 : p.t0;
    const bool rot = p.cos != nullptr && it.s >= p.text_len;
    const bool dparams = wants_dparams(sd);
    float c[VEC], sn[VEC], w[VEC];
    if (rot) {
      load8(p.cos + static_cast<long long>(it.s - p.text_len) * D + col, c);
      load8(p.sin + static_cast<long long>(it.s - p.text_len) * D + col, sn);
    }
    if (sd.norm) load_param(sd.w, col, p.params_bf16, 1.f, w);
    const T* x = static_cast<const T*>(sd.x) + it.b * sd.xb + it.s * sd.xs + col;
    const T* dy = static_cast<const T*>(sd.dy) + it.b * sd.db + it.s * sd.ds + col;
    const long long row0 = (static_cast<long long>(it.b) * p.seq + it.s) * p.heads;
    T* dx = static_cast<T*>(sd.dx) + row0 * D + col;
    for (int i0 = 0; i0 < iters; i0 += BWD_UNROLL) {
      float xv[BWD_UNROLL][VEC], g[BWD_UNROLL][VEC], mu[BWD_UNROLL], rs[BWD_UNROLL];
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        const int h = (i0 + u) * ROWS + grp;
        if (h < p.heads) {
          load8(dy + h * sd.dh, g[u]);
          if (sd.norm) {
            load8(x + h * D, xv[u]);
            mu[u] = sd.mean[row0 + h];
            rs[u] = sd.rstd[row0 + h];
          }
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) g[u][j] = xv[u][j] = 0.f;
          mu[u] = rs[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        const int h = (i0 + u) * ROWS + grp;
        if (rot) {   // the transposed rotation
#pragma unroll
          for (int j = 0; j < VEC; j += 2) {
            const float a = g[u][j], b = g[u][j + 1];
            g[u][j] = a * c[j] + b * sn[j + 1];
            g[u][j + 1] = b * c[j + 1] - a * sn[j];
          }
        }
        if (sd.norm) {
          float xhat[VEC], s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            xhat[j] = (xv[u][j] - mu[u]) * rs[u];
            if (dparams && it.t == 0) {
              acc_w[0][j] += g[u][j] * xhat[j];
              acc_b[0][j] += g[u][j];
            } else if (dparams) {
              acc_w[1][j] += g[u][j] * xhat[j];
              acc_b[1][j] += g[u][j];
            }
            g[u][j] *= w[j];
            s1 += g[u][j];
            s2 += g[u][j] * xhat[j];
          }
          s1 = group_sum(s1) * (1.f / D);
          s2 = group_sum(s2) * (1.f / D);
#pragma unroll
          for (int j = 0; j < VEC; ++j) g[u][j] = rs[u] * (g[u][j] - s1 - xhat[j] * s2);
        }
        if (h < p.heads) store8(dx + h * D, g[u]);
      }
    }
  }

  // dw / db partials: over the warp's 4 groups (same columns), then the block
  const bool any0 = wants_dparams(p.t0);
  const bool any1 = p.nt > 1 && wants_dparams(p.t1);
  if (!any0 && !any1) return;
  __shared__ float red[WARPS][4][D];   // [warp][dw0, db0, dw1, db1][column]
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float a = acc_w[t][j], b = acc_b[t][j];
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      b += __shfl_xor_sync(0xffffffffu, b, 8);
      b += __shfl_xor_sync(0xffffffffu, b, 16);
      if (grp == 0) {
        red[warp][2 * t][col + j] = a;
        red[warp][2 * t + 1][col + j] = b;
      }
    }
  }
  __syncthreads();
  const int k = threadIdx.x / D, cc = threadIdx.x % D;   // 4 rows x 64 columns
  float total = 0.f;
#pragma unroll
  for (int wi = 0; wi < WARPS; ++wi) total += red[wi][k][cc];
  const Side& sd = k < 2 ? p.t0 : p.t1;
  float* out = (k & 1) ? sd.dbias : sd.dw;
  if (out != nullptr) out[blockIdx.x * D + cc] = total;
}

Side side(const void* x, long long xb, long long xs, int norm, const void* w, const void* b,
          float eps) {
  Side s = {};
  s.x = x;
  s.xb = xb;
  s.xs = xs;
  s.norm = norm;
  s.w = w;
  s.b = b;
  s.eps = eps;
  return s;
}

}  // namespace

// Forward. Tensor 1 is used only when nt == 2. mean / rstd may be null (no
// backward to come). Returns cudaGetLastError() after the launch.
extern "C" int vp_qk_norm_rope_fwd(const void* x0, const void* x1, void* y0, void* y1,
                                   const void* w0, const void* b0, const void* w1,
                                   const void* b1, const void* cos, const void* sin,
                                   void* mean0, void* rstd0, void* mean1, void* rstd1,
                                   int nt, int batch, int seq, int heads, int text_len,
                                   long long x0b, long long x0s, long long x1b, long long x1s,
                                   int norm_mask, float eps0, float eps1, int fp32,
                                   int params_bf16, int grid, void* stream) {
  if (seq == 0 || batch == 0 || heads == 0) return 0;
  Params p = {};
  p.t0 = side(x0, x0b, x0s, norm_mask & 1, w0, b0, eps0);
  p.t1 = side(x1, x1b, x1s, (norm_mask >> 1) & 1, w1, b1, eps1);
  p.t0.y = y0;
  p.t1.y = y1;
  p.t0.mean = static_cast<float*>(mean0);
  p.t0.rstd = static_cast<float*>(rstd0);
  p.t1.mean = static_cast<float*>(mean1);
  p.t1.rstd = static_cast<float*>(rstd1);
  p.nt = nt;
  p.batch = batch;
  p.seq = seq;
  p.heads = heads;
  p.text_len = text_len;
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.params_bf16 = params_bf16;
  auto s = static_cast<cudaStream_t>(stream);
  if (fp32)
    qk_norm_rope_fwd_kernel<float><<<grid, THREADS, 0, s>>>(p);
  else
    qk_norm_rope_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Backward. dw* / db* are [grid, 64] fp32 partials or null (not wanted).
extern "C" int vp_qk_norm_rope_bwd(const void* x0, const void* x1, const void* dy0,
                                   const void* dy1, void* dx0, void* dx1, const void* w0,
                                   const void* w1, const void* cos, const void* sin,
                                   const void* mean0, const void* rstd0, const void* mean1,
                                   const void* rstd1, void* dw0, void* db0, void* dw1,
                                   void* db1, int nt, int batch, int seq, int heads,
                                   int text_len, long long x0b, long long x0s, long long x1b,
                                   long long x1s, long long dy0b, long long dy0s,
                                   long long dy0h, long long dy1b, long long dy1s,
                                   long long dy1h, int norm_mask, int fp32, int params_bf16,
                                   int grid, void* stream) {
  if (seq == 0 || batch == 0 || heads == 0) return 0;
  Params p = {};
  p.t0 = side(x0, x0b, x0s, norm_mask & 1, w0, nullptr, 0.f);
  p.t1 = side(x1, x1b, x1s, (norm_mask >> 1) & 1, w1, nullptr, 0.f);
  p.t0.dy = dy0;
  p.t0.db = dy0b;
  p.t0.ds = dy0s;
  p.t0.dh = dy0h;
  p.t1.dy = dy1;
  p.t1.db = dy1b;
  p.t1.ds = dy1s;
  p.t1.dh = dy1h;
  p.t0.dx = dx0;
  p.t1.dx = dx1;
  p.t0.mean = const_cast<float*>(static_cast<const float*>(mean0));
  p.t0.rstd = const_cast<float*>(static_cast<const float*>(rstd0));
  p.t1.mean = const_cast<float*>(static_cast<const float*>(mean1));
  p.t1.rstd = const_cast<float*>(static_cast<const float*>(rstd1));
  p.t0.dw = static_cast<float*>(dw0);
  p.t0.dbias = static_cast<float*>(db0);
  p.t1.dw = static_cast<float*>(dw1);
  p.t1.dbias = static_cast<float*>(db1);
  p.nt = nt;
  p.batch = batch;
  p.seq = seq;
  p.heads = heads;
  p.text_len = text_len;
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.params_bf16 = params_bf16;
  auto s = static_cast<cudaStream_t>(stream);
  if (fp32)
    qk_norm_rope_bwd_kernel<float><<<grid, THREADS, 0, s>>>(p);
  else
    qk_norm_rope_bwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
