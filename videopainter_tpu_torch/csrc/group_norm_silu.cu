// The VAE's GroupNorm, with the SiLU after it where there is one, for Hopper
// (sm_90a): split-group fp32 statistics, then a fused apply; two launches.
//
// It replaces no Pallas kernel: the JAX package leaves `group_norm`
// (videopainter_tpu/ops/basic.py:209) and `silu` to XLA's fusion. On the card
// the port ran them as eager passes: an fp32 copy of x, PyTorch's GroupNorm
// (its statistics one block per (batch, group): 32 blocks on 132 SMs at the
// VAE's 32 groups, each reducing up to 12.4 M values), the fp32 result cast
// back, then the SiLU: about 24 bytes moved a bf16 value. Contract:
//   x    : [B, C, T, P] as the wrapper views it (P = H * W), any batch,
//          channel and frame strides, each plane contiguous; bf16 or fp32
//   y    : [B, C, T, P] contiguous, x's dtype
//   mean, rstd of each (batch, group) over its C / G channels, T frames and P
//          values, in fp32: biased variance, rstd = rsqrt(M2 / n + eps), as
//          F.group_norm and the JAX `group_norm` compute them
//   y    = round(x a + s) with a = rstd w[c], s = b[c] - mean a (F.group_norm's
//          fused affine on the card), then with `silu` round(v / (1 + exp(-v)))
//          of that rounded v: the rounding points of the plain version
//          (ops/group_norm.py `group_norm_silu_reference`).
//
// What bounds it on the H100: bytes. x is read twice (the statistics, then the
// apply) and y written once: 6 B a bf16 value. Down block 0's largest call,
// [1, 128, 9, 480, 720], moves 2.39 GB: 0.713 ms at 3.35 TB/s. The design:
//  - each (batch, group) span of the flattened [C / G, T, P] is cut into
//    chunks of equal length, one block a chunk; the wrapper picks their count
//    from the group's size so that the grid holds several blocks an SM
//    whatever the number of groups (ops/group_norm.py `plan`);
//  - a thread reads 16 bytes at a time (8 bf16 or 4 fp32 values; one value
//    where the layout does not allow it), UNROLL loads in flight before any
//    arithmetic; a vector's plane, channel and frame come from two
//    multiply-shift divisions (the wrapper computes the multipliers);
//  - statistics (`group_norm_stats_kernel`): each batch of a thread's loads is
//    reduced in registers (its sum, then the squares of its deviations from
//    its own mean) and merged into the thread's fp32 (count, mean, M2) by
//    Chan's formula; threads merge by warp shuffles, warps through shared
//    memory; one fp32 partial a block;
//  - apply (`group_norm_apply_kernel`): each block first merges its group's
//    partials in a fixed order (so a call gives the same bits every time), then
//    reads its chunk of x once and writes y once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;

struct Div {             // n / d for 0 <= n < 2^31: umulhi(n, mul) >> shift (d > 1)
  unsigned d, mul, shift;
};

__device__ __forceinline__ unsigned divide(unsigned n, const Div& f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shift;
}

struct Params {
  const void* x;
  void* y;
  const void* w;           // [C] affine weight
  const void* b;           // [C] affine bias
  float4* part;            // [B * G * nchunk]: (count, mean, M2, -) of each chunk
  float* mean;             // [B * G], written where not null
  float* rstd;
  long long sb, sc, st;    // x's batch, channel and frame strides (elements)
  int groups, cg;          // G, channels a group
  unsigned frames, plane;  // T, P
  unsigned group_elems;    // cg * T * P, below 2^31
  unsigned chunk;          // elements a block, a multiple of the vector width
  int nchunk;
  Div by_plane, by_frames;
  float eps;
  int silu, params_bf16;
};

__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}

__device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = *p; }

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }

// A value rounded to the storage type T and read back as fp32.
template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

// v / (1 + exp(-v)), F.silu's formula. Under a bf16 result the fast exp and
// division (a few fp32 ulps, far below bf16's spacing) keep the apply bound by
// bytes; an fp32 result takes the accurate ones.
template <typename T>
__device__ __forceinline__ float silu(float v) {
  if constexpr (sizeof(T) == 2) {
    return __fdividef(v, 1.f + __expf(-v));
  } else {
    return v / (1.f + expf(-v));
  }
}

// Channel c's affine weight or bias (bf16 or fp32).
__device__ __forceinline__ float param(const void* p, int c, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

struct Moments {
  float n, mean, m2;
};

// Chan's formula: merge (nb, mb, m2b) into a.
__device__ __forceinline__ void merge(Moments& a, float nb, float mb, float m2b) {
  const float n = a.n + nb;
  if (n == 0.f) return;
  const float d = mb - a.mean;
  const float r = nb / n;
  a.mean = fmaf(d, r, a.mean);
  a.m2 = a.m2 + m2b + d * (a.n * r) * d;   // 0 where a is empty, whatever d
  a.n = n;
}

__device__ __forceinline__ void merge_from_lane(Moments& m, int off) {
  const float nb = __shfl_down_sync(0xffffffffu, m.n, off);
  const float mb = __shfl_down_sync(0xffffffffu, m.mean, off);
  const float qb = __shfl_down_sync(0xffffffffu, m.m2, off);
  merge(m, nb, mb, qb);
}

// The block's moments, merged in a fixed order; meaningful in thread 0.
__device__ __forceinline__ Moments block_moments(Moments m) {
  __shared__ float sh[3][WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge_from_lane(m, off);
  if (lane == 0) {
    sh[0][warp] = m.n;
    sh[1][warp] = m.mean;
    sh[2][warp] = m.m2;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < WARPS ? Moments{sh[0][lane], sh[1][lane], sh[2][lane]} : Moments{0.f, 0.f, 0.f};
#pragma unroll
    for (int off = WARPS / 2; off > 0; off >>= 1) merge_from_lane(m, off);
  }
  return m;
}

// Where element e of a group lies: its channel within the group, and its
// offset in x from the group's first channel.
__device__ __forceinline__ long long locate(const Params& p, unsigned e, unsigned& cl) {
  const unsigned pl = divide(e, p.by_plane);   // the plane within the group
  const unsigned o = e - pl * p.plane;
  cl = divide(pl, p.by_frames);
  const unsigned t = pl - cl * p.frames;
  return cl * p.sc + t * p.st + o;
}

// One block a (batch, group, chunk): the chunk's fp32 (count, mean, M2).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) group_norm_stats_kernel(const Params p) {
  const int grp = blockIdx.x / p.nchunk;       // batch * G + group
  const int chunk = blockIdx.x - grp * p.nchunk;
  const int bi = grp / p.groups;
  const int g = grp - bi * p.groups;
  const T* x = static_cast<const T*>(p.x) + bi * p.sb + static_cast<long long>(g) * p.cg * p.sc;
  const unsigned e0 = chunk * p.chunk;
  const unsigned e1 = min(e0 + p.chunk, p.group_elems);
  Moments m = {0.f, 0.f, 0.f};
  for (unsigned base = e0 + threadIdx.x * VEC; base < e1; base += THREADS * VEC * UNROLL) {
    float v[UNROLL][VEC];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned e = base + u * THREADS * VEC;
      ok[u] = e < e1;
      unsigned cl;
      if (ok[u]) load(x + locate(p, e, cl), v[u]);
    }
    float s = 0.f, cnt = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      cnt += VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += v[u][j];
    }
    const float mb = s / cnt;                  // ok[0] holds: cnt >= VEC
    float q = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[u][j] - mb;
        q = fmaf(d, d, q);
      }
    }
    merge(m, cnt, mb, q);
  }
  m = block_moments(m);
  if (threadIdx.x == 0) p.part[blockIdx.x] = make_float4(m.n, m.mean, m.m2, 0.f);
}

// One block a (batch, group, chunk): merge the group's partials, then
// normalise the chunk (and apply the SiLU) into y.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) group_norm_apply_kernel(const Params p) {
  __shared__ float stat[2];
  const int grp = blockIdx.x / p.nchunk;
  const int chunk = blockIdx.x - grp * p.nchunk;
  const int bi = grp / p.groups;
  const int g = grp - bi * p.groups;
  Moments m = {0.f, 0.f, 0.f};
  const float4* part = p.part + static_cast<long long>(grp) * p.nchunk;
  for (int i = threadIdx.x; i < p.nchunk; i += THREADS) {
    const float4 q = part[i];
    merge(m, q.x, q.y, q.z);
  }
  m = block_moments(m);
  if (threadIdx.x == 0) {
    const float rs = rsqrtf(m.m2 / m.n + p.eps);
    stat[0] = m.mean;
    stat[1] = rs;
    if (chunk == 0 && p.mean != nullptr) {
      p.mean[grp] = m.mean;
      p.rstd[grp] = rs;
    }
  }
  __syncthreads();
  const float mean = stat[0];
  const float rstd = stat[1];
  const T* x = static_cast<const T*>(p.x) + bi * p.sb + static_cast<long long>(g) * p.cg * p.sc;
  T* y = static_cast<T*>(p.y) + static_cast<long long>(grp) * p.group_elems;
  const int c0 = g * p.cg;
  const unsigned e0 = chunk * p.chunk;
  const unsigned e1 = min(e0 + p.chunk, p.group_elems);
  for (unsigned base = e0 + threadIdx.x * VEC; base < e1; base += THREADS * VEC * UNROLL) {
    float v[UNROLL][VEC];
    unsigned cl[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned e = base + u * THREADS * VEC;
      ok[u] = e < e1;
      if (ok[u]) load(x + locate(p, e, cl[u]), v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      const int c = c0 + static_cast<int>(cl[u]);
      const float a = rstd * param(p.w, c, p.params_bf16);
      const float s = fmaf(-a, mean, param(p.b, c, p.params_bf16));
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float r = round_to<T>(fmaf(v[u][j], a, s));
        if (p.silu) r = round_to<T>(silu<T>(r));
        v[u][j] = r;
      }
      store(y + base + u * THREADS * VEC, v[u]);
    }
  }
}

template <typename T, int VEC>
int launch(const Params& p, int grid, cudaStream_t s) {
  group_norm_stats_kernel<T, VEC><<<grid, THREADS, 0, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  group_norm_apply_kernel<T, VEC><<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launches on `stream`. part: [batch * groups * nchunk, 4] fp32 scratch;
// mean / rstd: [batch * groups] fp32 or null. cg * frames * plane < 2^31; the
// multipliers and shifts of the divisions by plane and frames fit 32 bits. vec:
// 8 (bf16) or 4 (fp32) where every plane starts 16-byte aligned and P divides
// by it, else 1.
extern "C" int vp_group_norm_silu(const void* x, void* y, const void* w, const void* b,
                                  void* part, void* mean, void* rstd, int batch, int groups,
                                  int cg, long long frames, long long plane, long long sb,
                                  long long sc, long long st, long long chunk, int nchunk,
                                  long long plane_mul, long long plane_shift,
                                  long long frames_mul, long long frames_shift, float eps,
                                  int silu, int fp32, int params_bf16, int vec, void* stream) {
  if (batch == 0 || groups == 0 || cg == 0 || frames == 0 || plane == 0) return 0;
  Params p = {};
  p.x = x;
  p.y = y;
  p.w = w;
  p.b = b;
  p.part = static_cast<float4*>(part);
  p.mean = static_cast<float*>(mean);
  p.rstd = static_cast<float*>(rstd);
  p.sb = sb;
  p.sc = sc;
  p.st = st;
  p.groups = groups;
  p.cg = cg;
  p.frames = static_cast<unsigned>(frames);
  p.plane = static_cast<unsigned>(plane);
  p.group_elems = static_cast<unsigned>(cg * frames * plane);
  p.chunk = static_cast<unsigned>(chunk);
  p.nchunk = nchunk;
  p.by_plane = Div{p.plane, static_cast<unsigned>(plane_mul), static_cast<unsigned>(plane_shift)};
  p.by_frames = Div{p.frames, static_cast<unsigned>(frames_mul),
                    static_cast<unsigned>(frames_shift)};
  p.eps = eps;
  p.silu = silu;
  p.params_bf16 = params_bf16;
  const int grid = batch * groups * nchunk;
  auto s = static_cast<cudaStream_t>(stream);
  if (fp32 && vec == 4) return launch<float, 4>(p, grid, s);
  if (fp32 && vec == 1) return launch<float, 1>(p, grid, s);
  if (!fp32 && vec == 8) return launch<__nv_bfloat16, 8>(p, grid, s);
  if (!fp32 && vec == 1) return launch<__nv_bfloat16, 1>(p, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
