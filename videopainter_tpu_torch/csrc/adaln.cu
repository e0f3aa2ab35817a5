// AdaLN for Hopper (sm_90a): CogVideoX's LayerNormZero / AdaLayerNorm, the
// fp32 layer norm, the modulation and the casts in one pass, forward and
// backward.
//
// It replaces no Pallas kernel: the JAX package leaves `layer_norm_zero` and
// `ada_layer_norm` (videopainter_tpu/ops/norms.py) to XLA's fusion. On the
// card the port ran them as eager passes: an fp32 copy of x, the layer norm,
// a cast back, an fp32 copy, `* (1 + scale)`, `+ shift`, a cast: about 48
// bytes moved a bf16 value. Contract, for each stream t (the video rows, and
// the text rows where there are any; both share the norm's weights):
//   x     : [B, S_t, D] with any batch and token strides, each row contiguous
//           and 16-byte aligned; bf16 or fp32. D a multiple of 8 up to 4096.
//   shift, scale : fp32 [B, D] rows (any batch stride), the modulation of t
//   y     : [B, S_t, D] contiguous, x's dtype:
//           n  = round((x - mean) rstd w + b)       (LayerNorm, fp32 affine)
//           y  = round(n (1 + scale) + shift)        (each op rounded in fp32)
//           with mean and biased variance in fp32 (two passes over the row
//           held in registers), rstd = rsqrt(var + eps): the rounding points
//           of ops/adaln.py `adaln_reference` (and the JAX `layer_norm_zero`).
//
// What bounds it on the H100: bytes. It has to read x once and write y once:
// 4 B a bf16 value. A served call (video [2, 17,776, 3,072] and text [2, 226,
// 3,072]) moves 442 MB, 0.132 ms at 3.35 TB/s. The forward's design:
//  - one warp a row: lane l reads the row's 16-byte vectors l, l + 32, ...
//    (12 at D = 3,072, all issued before any arithmetic: 6 KB in flight a
//    warp) and keeps them packed in registers; the mean, then the squared
//    deviations from it, are summed in the lane and over the warp by xor
//    shuffles in a fixed order, so a call gives the same bits every time and
//    no warp waits at a barrier for another;
//  - the columns' w, b, scale and shift are read while the row is written,
//    from L1: every row of a (stream, batch) reads the same ones, and the
//    rows themselves are loaded and stored as streams (evict first), so that
//    they do not push those out;
//  - one row a warp, eight warps a block, as many blocks as rows / 8: the
//    scheduler keeps the SMs full and the tail is one row long.
// The backward reads x, dy and the saved fp32 mean and rstd (8 B a row), and
// writes dx, all in fp32 from dy to dx:
//   g = dy (1 + scale), dx = rstd (g w - mean(g w) - xhat mean(g w xhat)),
//   d_shift = sum dy, d_scale = sum dy n (n as rounded in the forward),
//   dw = sum g xhat, db = sum g,
// the four column sums kept per thread in registers over the rows its block
// visits. So the backward holds a row across a block: thread i owns the 8
// columns of one 16-byte load (D / 8 threads rounded up to a warp, 384 at
// D = 3,072) with their w, b and 1 + scale in registers; a unit is BWD_ROWS
// rows, whose two row sums go through warp shuffles and one shared-memory
// exchange in a fixed order, and the next unit's rows are loaded before the
// current one's sums. Each block covers rows of one (stream, batch) only and,
// where the caller asks for the column sums, writes them as one fp32 [4, D]
// partial; the caller adds a segment's partials in a fixed order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int VEC = 8;            // values a thread a row: one 16-byte bf16 load
constexpr int MAX_DIM = 4096;
constexpr int MAX_THREADS = MAX_DIM / VEC;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int FWD_THREADS = 256;
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int FWD_BLOCKS = 2;       // resident blocks an SM: 128 registers a thread
                                    // (3 spill and read 66 % of the bound, 2 72 %)
constexpr int BWD_ROWS = 2;

struct Stream {
  const void* x;             // [B, S, D]
  long long xb, xs;          // its batch and token strides (elements)
  void* y;                   // forward: [B, S, D] contiguous
  const void* dy;            // backward: the output's gradient
  long long db, ds;          // its batch and token strides (elements)
  void* dx;                  // backward: [B, S, D] contiguous
  const float* shift;        // [B, D] rows
  const float* scale;
  long long shift_b, scale_b;   // their batch strides
  float* mean;               // [B, S]; forward: written where not null
  float* rstd;
  int rows;                  // S
  int blocks;                // backward: blocks a batch
};

struct Params {
  Stream t0, t1;
  int nt, batch, dim, nvec;  // streams, B, D, D / 8
  float eps;
  const void* w;             // [D] affine weight, or null
  const void* b;             // [D] affine bias, or null
  int params_bf16;           // w and b are bf16 (else fp32)
  float* part;               // backward: [grid, 4, D] column sums, or null
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

// The same, as a stream nothing reads again soon (evict first): the
// forward's rows, so that they do not push the columns' parameters out of L1.
__device__ __forceinline__ void store8_cs(__nv_bfloat16* p, const float v[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

__device__ __forceinline__ void store8_cs(float* p, const float v[VEC]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
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

// The weight's or bias's 8 values at `col`: `fill` where absent.
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

// 1 + scale and shift of batch b at `col`, 1 + scale rounded as the eager add;
// zeros for a thread past the row's end, so that it adds nothing to a sum.
__device__ __forceinline__ void load_mod(const Stream& s, int b, int col, bool active,
                                         float ops[VEC], float sh[VEC]) {
  if (!active) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) ops[j] = sh[j] = 0.f;
    return;
  }
  load8(s.scale + b * s.scale_b + col, ops);
  load8(s.shift + b * s.shift_b + col, sh);
#pragma unroll
  for (int j = 0; j < VEC; ++j) ops[j] = __fadd_rn(1.f, ops[j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Each of the N values summed over the block, the same in every thread:
// warps by shuffles, then the warps' sums in order from `red` [MAX_WARPS][N].
template <int N>
__device__ __forceinline__ void block_sums(float v[N], float (*red)[N]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < N; ++u) v[u] = warp_sum(v[u]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int u = 0; u < N; ++u) red[warp][u] = v[u];
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int u = 0; u < N; ++u) v[u] = 0.f;
  for (int wi = 0; wi < warps; ++wi) {
#pragma unroll
    for (int u = 0; u < N; ++u) v[u] += red[wi][u];
  }
}

// A row's 16-byte vectors as a lane keeps them: 8 bf16 values packed in a
// uint4, or 8 fp32 values in two float4.
template <typename T>
struct Raw;

template <>
struct Raw<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float v[VEC]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float v[VEC]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// One warp a row: lane l holds the row's vectors l, l + 32, ... (NV at most,
// so D <= 256 NV), read once; the mean and the squared deviations are summed
// in the lane, then over the warp by shuffles in a fixed order, so no barrier
// and no shared memory. The columns' w, b, scale and shift are read as the
// row is written, from L1 (every row of a (stream, batch) reads the same
// ones).
template <typename T, int NV>
__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS) adaln_fwd_kernel(const __grid_constant__ Params p) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * FWD_WARPS + (threadIdx.x >> 5);
  const long long rows0 = static_cast<long long>(p.batch) * p.t0.rows;
  if (row >= rows0 + static_cast<long long>(p.batch) * p.t1.rows) return;
  const int t = row >= rows0;
  const Stream& s = t ? p.t1 : p.t0;
  const long long rl = t ? row - rows0 : row;
  const int b = static_cast<int>(rl / s.rows);
  const int r = static_cast<int>(rl - static_cast<long long>(b) * s.rows);
  const T* x = static_cast<const T*>(s.x) + b * s.xb + r * s.xs;
  Raw<T> raw[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < p.nvec) raw[i].load(x + (lane + 32 * i) * VEC);
  float mu = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < p.nvec) {
      float v[VEC];
      raw[i].get(v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) mu += v[j];
    }
  }
  const float inv_d = 1.f / p.dim;
  mu = warp_sum(mu) * inv_d;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < p.nvec) {
      float v[VEC];
      raw[i].get(v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[j] - mu;
        var = fmaf(d, d, var);
      }
    }
  }
  const float rs = rsqrtf(warp_sum(var) * inv_d + p.eps);
  T* y = static_cast<T*>(s.y) + rl * p.dim;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (lane + 32 * i) * VEC;
    if (lane + 32 * i >= p.nvec) continue;
    float v[VEC], w[VEC], bias[VEC], ops[VEC], sh[VEC];
    raw[i].get(v);
    load_param(p.w, col, p.params_bf16, 1.f, w);
    load_param(p.b, col, p.params_bf16, 0.f, bias);
    load_mod(s, b, col, true, ops, sh);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float n = round_to<T>(fmaf((v[j] - mu) * rs, w[j], bias[j]));
      v[j] = __fadd_rn(__fmul_rn(n, ops[j]), sh[j]);   // no contraction: as eager
    }
    store8_cs(y + col, v);
  }
  if (s.mean != nullptr && lane == 0) {
    s.mean[rl] = mu;
    s.rstd[rl] = rs;
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1) adaln_bwd_kernel(const __grid_constant__ Params p) {
  __shared__ float red[2][MAX_WARPS][2 * BWD_ROWS];
  const int vec = threadIdx.x;
  const bool active = vec < p.nvec;
  const int col = active ? vec * VEC : 0;
  const float inv_d = 1.f / p.dim;
  // this block's (stream, batch) and its place among the blocks given to it
  const int blocks0 = p.batch * p.t0.blocks;
  const int t = blockIdx.x >= blocks0;
  const Stream& s = t ? p.t1 : p.t0;
  const int bl = t ? blockIdx.x - blocks0 : blockIdx.x;
  const int b = bl / s.blocks;
  const int j0 = bl - b * s.blocks;
  const bool sums = p.part != nullptr;
  float w[VEC], bias[VEC], ops[VEC], sh[VEC];
  load_param(active ? p.w : nullptr, col, p.params_bf16, 1.f, w);
  load_param(active ? p.b : nullptr, col, p.params_bf16, 0.f, bias);
  load_mod(s, b, col, active, ops, sh);
  float acc_sh[VEC], acc_sc[VEC], acc_w[VEC], acc_b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc_sh[j] = acc_sc[j] = acc_w[j] = acc_b[j] = 0.f;
  const T* x = static_cast<const T*>(s.x) + b * s.xb + col;
  const T* dy = static_cast<const T*>(s.dy) + b * s.db + col;
  T* dx = static_cast<T*>(s.dx) + static_cast<long long>(b) * s.rows * p.dim + col;
  const float* mean = s.mean + static_cast<long long>(b) * s.rows;
  const float* rstd = s.rstd + static_cast<long long>(b) * s.rows;
  const int units = (s.rows + BWD_ROWS - 1) / BWD_ROWS;
  // one unit's rows: x, dy, mean and rstd (zeros past the stream's end or the row's)
  auto load_rows = [&](int unit, float (*xv)[VEC], float (*g)[VEC], float* mu, float* rs) {
#pragma unroll
    for (int u = 0; u < BWD_ROWS; ++u) {
      const int r = unit * BWD_ROWS + u;
      mu[u] = r < s.rows ? mean[r] : 0.f;
      rs[u] = r < s.rows ? rstd[r] : 0.f;
      if (active && r < s.rows) {
        load8(x + static_cast<long long>(r) * s.xs, xv[u]);
        load8(dy + static_cast<long long>(r) * s.ds, g[u]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) xv[u][j] = g[u][j] = 0.f;
      }
    }
  };
  float xv[BWD_ROWS][VEC], g[BWD_ROWS][VEC], mu[BWD_ROWS], rs[BWD_ROWS];
  float nxv[BWD_ROWS][VEC], ng[BWD_ROWS][VEC], nmu[BWD_ROWS], nrs[BWD_ROWS];
  if (j0 < units) load_rows(j0, xv, g, mu, rs);
  int parity = 0;
  for (int unit = j0; unit < units; unit += s.blocks, parity ^= 1) {
    const int r0 = unit * BWD_ROWS;
    if (unit + s.blocks < units) load_rows(unit + s.blocks, nxv, ng, nmu, nrs);
    float rsum[2 * BWD_ROWS];   // per row: sum g w, sum g w xhat
#pragma unroll
    for (int u = 0; u < BWD_ROWS; ++u) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (xv[u][j] - mu[u]) * rs[u];
        const float gy = g[u][j];
        const float gn = gy * ops[j];
        if (sums) {
          const float n = round_to<T>(fmaf(xhat, w[j], bias[j]));
          acc_sh[j] += gy;
          acc_sc[j] = fmaf(gy, n, acc_sc[j]);
          acc_w[j] = fmaf(gn, xhat, acc_w[j]);
          acc_b[j] += gn;
        }
        const float gw = gn * w[j];
        xv[u][j] = xhat;
        g[u][j] = gw;
        s1 += gw;
        s2 = fmaf(gw, xhat, s2);
      }
      rsum[2 * u] = s1;
      rsum[2 * u + 1] = s2;
    }
    block_sums<2 * BWD_ROWS>(rsum, red[parity]);
#pragma unroll
    for (int u = 0; u < BWD_ROWS; ++u) {
      if (!active || r0 + u >= s.rows) continue;
      const float m1 = rsum[2 * u] * inv_d, m2 = rsum[2 * u + 1] * inv_d;
#pragma unroll
      for (int j = 0; j < VEC; ++j) g[u][j] = rs[u] * (g[u][j] - m1 - xv[u][j] * m2);
      store8(dx + static_cast<long long>(r0 + u) * p.dim, g[u]);
    }
#pragma unroll
    for (int u = 0; u < BWD_ROWS; ++u) {
      mu[u] = nmu[u];
      rs[u] = nrs[u];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        xv[u][j] = nxv[u][j];
        g[u][j] = ng[u][j];
      }
    }
  }
  if (sums && active) {
    float* part = p.part + static_cast<long long>(blockIdx.x) * 4 * p.dim + col;
    store8(part, acc_sh);
    store8(part + p.dim, acc_sc);
    store8(part + 2 * p.dim, acc_w);
    store8(part + 3 * p.dim, acc_b);
  }
}

Stream stream(const void* x, long long xb, long long xs, const void* shift, long long shift_b,
              const void* scale, long long scale_b, int rows) {
  Stream s = {};
  s.x = x;
  s.xb = xb;
  s.xs = xs;
  s.shift = static_cast<const float*>(shift);
  s.scale = static_cast<const float*>(scale);
  s.shift_b = shift_b;
  s.scale_b = scale_b;
  s.rows = rows;
  return s;
}

int threads(int dim) { return (dim / VEC + 31) / 32 * 32; }

template <typename T, int NV>
int launch_fwd(const Params& p, long long rows, cudaStream_t s) {
  const long long grid = (rows + FWD_WARPS - 1) / FWD_WARPS;
  adaln_fwd_kernel<T, NV><<<static_cast<unsigned>(grid), FWD_THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instance whose lanes hold a whole row: 8, 12 or 16 vectors a lane.
template <typename T>
int launch_fwd(const Params& p, long long rows, cudaStream_t s) {
  if (p.nvec <= 32 * 8) return launch_fwd<T, 8>(p, rows, s);
  if (p.nvec <= 32 * 12) return launch_fwd<T, 12>(p, rows, s);
  return launch_fwd<T, 16>(p, rows, s);
}

bool bad_dim(int dim) { return dim <= 0 || dim % VEC != 0 || dim > MAX_DIM; }

}  // namespace

// Forward. Stream 1 is used only when nt == 2. mean / rstd may be null (no
// backward to come). Returns cudaGetLastError() after the launch.
extern "C" int vp_adaln_fwd(const void* x0, const void* x1, void* y0, void* y1, const void* w,
                            const void* b, const void* shift0, const void* scale0,
                            const void* shift1, const void* scale1, void* mean0, void* rstd0,
                            void* mean1, void* rstd1, int nt, int batch, int rows0, int rows1,
                            int dim, long long x0b, long long x0s, long long x1b, long long x1s,
                            long long shift0_b, long long scale0_b, long long shift1_b,
                            long long scale1_b, float eps, int fp32, int params_bf16,
                            void* stream_) {
  if (bad_dim(dim)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.t0 = stream(x0, x0b, x0s, shift0, shift0_b, scale0, scale0_b, rows0);
  p.t1 = stream(x1, x1b, x1s, shift1, shift1_b, scale1, scale1_b, nt > 1 ? rows1 : 0);
  p.t0.y = y0;
  p.t1.y = y1;
  p.t0.mean = static_cast<float*>(mean0);
  p.t0.rstd = static_cast<float*>(rstd0);
  p.t1.mean = static_cast<float*>(mean1);
  p.t1.rstd = static_cast<float*>(rstd1);
  p.nt = nt;
  p.batch = batch;
  p.dim = dim;
  p.nvec = dim / VEC;
  p.eps = eps;
  p.w = w;
  p.b = b;
  p.params_bf16 = params_bf16;
  const long long rows = static_cast<long long>(batch) * (p.t0.rows + p.t1.rows);
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream_);
  if (fp32) return launch_fwd<float>(p, rows, s);
  return launch_fwd<__nv_bfloat16>(p, rows, s);
}

// Backward. The grid is batch * (blocks0 + blocks1) blocks (blocks1 only when
// nt == 2): blocks0 a batch of stream 0, then blocks1 a batch of stream 1.
// part: [grid, 4, dim] fp32 (d_shift, d_scale, dw, db of each block's rows) or
// null (not wanted).
extern "C" int vp_adaln_bwd(const void* x0, const void* x1, const void* dy0, const void* dy1,
                            void* dx0, void* dx1, const void* w, const void* b,
                            const void* shift0, const void* scale0, const void* shift1,
                            const void* scale1, const void* mean0, const void* rstd0,
                            const void* mean1, const void* rstd1, void* part, int nt, int batch,
                            int rows0, int rows1, int dim, int blocks0, int blocks1,
                            long long x0b, long long x0s, long long x1b, long long x1s,
                            long long dy0b, long long dy0s, long long dy1b, long long dy1s,
                            long long shift0_b, long long scale0_b, long long shift1_b,
                            long long scale1_b, int fp32, int params_bf16, void* stream_) {
  if (bad_dim(dim) || blocks0 <= 0 || (nt > 1 && blocks1 <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Params p = {};
  p.t0 = stream(x0, x0b, x0s, shift0, shift0_b, scale0, scale0_b, rows0);
  p.t1 = stream(x1, x1b, x1s, shift1, shift1_b, scale1, scale1_b, nt > 1 ? rows1 : 0);
  p.t0.dy = dy0;
  p.t0.db = dy0b;
  p.t0.ds = dy0s;
  p.t1.dy = dy1;
  p.t1.db = dy1b;
  p.t1.ds = dy1s;
  p.t0.dx = dx0;
  p.t1.dx = dx1;
  p.t0.mean = const_cast<float*>(static_cast<const float*>(mean0));
  p.t0.rstd = const_cast<float*>(static_cast<const float*>(rstd0));
  p.t1.mean = const_cast<float*>(static_cast<const float*>(mean1));
  p.t1.rstd = const_cast<float*>(static_cast<const float*>(rstd1));
  p.t0.blocks = blocks0;
  p.t1.blocks = nt > 1 ? blocks1 : 0;
  p.nt = nt;
  p.batch = batch;
  p.dim = dim;
  p.nvec = dim / VEC;
  p.w = w;
  p.b = b;
  p.params_bf16 = params_bf16;
  p.part = static_cast<float*>(part);
  const int grid = batch * (p.t0.blocks + p.t1.blocks);
  auto s = static_cast<cudaStream_t>(stream_);
  if (fp32)
    adaln_bwd_kernel<float><<<grid, threads(dim), 0, s>>>(p);
  else
    adaln_bwd_kernel<__nv_bfloat16><<<grid, threads(dim), 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
