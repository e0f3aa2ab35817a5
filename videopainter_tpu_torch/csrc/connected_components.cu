// Connected-components labelling (8-connectivity) of a batch of binary masks,
// with each component's area, for Hopper (sm_90a).
//
// The reference's one native kernel was CUDA (app/sam2/csrc/
// connected_components.cu, SAM2's mask post-processing); the JAX package
// replaced it by videopainter_tpu/native/connected_components.cpp (a host
// union-find) and connected_components_jax (a lax.while_loop of 3x3 min-pools),
// videopainter_tpu/native/__init__.py:63-126. Contract:
//   input : uint8 mask [B, 1, H, W], nonzero = foreground
//   labels: int32 [B, 1, H, W], 0 on the background, components numbered from
//           1 in the raster order of their first pixel (as both JAX versions)
//   areas : int32 [B, 1, H, W], the size of the pixel's component, 0 on the
//           background
//
// What bounds it on the H100: bytes. It must read 1 byte and write 8 a pixel:
// 8 x 1024 x 1024 masks take 75 MB, 22 us at 3.35 TB/s. The union-find's
// pointer chasing is latency-bound and data-dependent; this first version is
// simple and right, and leaves speed to a later change:
//  1. init:    parent[i] = i on the foreground (-1 elsewhere), areas = 0;
//  2. merge:   each foreground pixel unites with its W, NW, N and NE
//              neighbours. A union links the larger root under the smaller
//              with atomicMin, so a root is always its component's smallest
//              (global, raster) index; a union that loses a race re-finds
//              from the value the atomic returned. Parents are read through
//              L2 (__ldcg), since other SMs write them during the pass;
//  3. flatten: each pixel finds its root, points at it, adds 1 to the
//              root's area (atomicAdd into `areas`), and each 1024-pixel tile
//              counts its roots (__syncthreads_count);
//  4. scan:    one block per image scans its tiles' root counts;
//  5. rank:    each tile ranks its roots (ballot prefix within warps, a scan
//              of the warp counts) and writes rank + 1 at the root's slot of
//              `labels`;
//  6. write:   every pixel copies its root's label and area (a root rewrites
//              its own slot with the value it holds; no other pixel's slot is
//              read), 0 on the background.
// Steps 2, 3 and 6 each need the previous pass complete across the grid, so
// each is a separate launch on the caller's stream. Scratch (parent, tile
// counts) comes from the caller (torch's allocator).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;   // pixels of one image per block, one per thread

__device__ __forceinline__ int find_l2(const int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ __forceinline__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_l2(parent, a);
    b = find_l2(parent, b);
    if (a == b) return;
    if (a > b) { int t = a; a = b; b = t; }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;   // b was a root and now hangs under a
    b = old;                // b had been linked elsewhere meanwhile: unite a with that
  }
}

// Grid (tiles, B): pixel `local` of image blockIdx.y; global index g.
struct Px {
  int local, g, hw;
  bool valid;
};

__device__ __forceinline__ Px pixel(int hw) {
  Px p;
  p.hw = hw;
  p.local = blockIdx.x * TILE + threadIdx.x;
  p.valid = p.local < hw;
  p.g = blockIdx.y * hw + p.local;
  return p;
}

__global__ void cc_init(const uint8_t* __restrict__ mask, int* __restrict__ parent,
                        int* __restrict__ areas, int hw) {
  const Px p = pixel(hw);
  if (!p.valid) return;
  parent[p.g] = mask[p.g] ? p.g : -1;
  areas[p.g] = 0;
}

__global__ void cc_merge(const uint8_t* __restrict__ mask, int* parent, int h, int w) {
  const Px p = pixel(h * w);
  if (!p.valid || !mask[p.g]) return;
  const int y = p.local / w, x = p.local - y * w;
  if (x > 0 && mask[p.g - 1]) unite(parent, p.g, p.g - 1);
  if (y > 0) {
    const int up = p.g - w;
    if (x > 0 && mask[up - 1]) unite(parent, p.g, up - 1);
    if (mask[up]) unite(parent, p.g, up);
    if (x + 1 < w && mask[up + 1]) unite(parent, p.g, up + 1);
  }
}

__global__ void cc_flatten(int* parent, int* areas, int* __restrict__ tile_roots, int hw) {
  const Px p = pixel(hw);
  bool is_root = false;
  if (p.valid) {
    const int q = parent[p.g];
    if (q >= 0) {
      const int r = find_l2(parent, p.g);
      parent[p.g] = r;   // another thread may follow this pointer: r is an ancestor
      atomicAdd(areas + r, 1);
      is_root = r == p.g;
    }
  }
  const int n = __syncthreads_count(is_root);
  if (threadIdx.x == 0) tile_roots[blockIdx.y * gridDim.x + blockIdx.x] = n;
}

// Exclusive scan of 1024 values held one per thread; returns the thread's
// prefix and, through `total`, the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < (blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    warp_sums[lane] = s;   // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();   // warp_sums is reused by the next call
  return before + incl - v;
}

// One block per image: tile_roots[b, :] -> exclusive offsets, in place.
__global__ void cc_scan_tiles(int* tile_roots, int tiles) {
  int* t = tile_roots + blockIdx.y * tiles;
  int carry = 0;
  for (int base = 0; base < tiles; base += TILE) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? t[i] : 0;
    int total;
    const int ex = block_exclusive_scan(v, &total);
    if (i < tiles) t[i] = carry + ex;
    carry += total;
  }
}

__global__ void cc_rank(const int* __restrict__ parent, const int* __restrict__ tile_offsets,
                        int* __restrict__ labels, int hw) {
  const Px p = pixel(hw);
  const bool is_root = p.valid && parent[p.g] == p.g;
  int total;
  const int ex = block_exclusive_scan(is_root ? 1 : 0, &total);
  if (is_root) labels[p.g] = tile_offsets[blockIdx.y * gridDim.x + blockIdx.x] + ex + 1;
}

__global__ void cc_write(const int* __restrict__ parent, int* labels, int* areas, int hw) {
  const Px p = pixel(hw);
  if (!p.valid) return;
  const int r = parent[p.g];
  if (r < 0) {
    labels[p.g] = 0;
    areas[p.g] = 0;
  } else if (r != p.g) {
    labels[p.g] = labels[r];
    areas[p.g] = areas[r];
  }
}

}  // namespace

// mask uint8 [B, H, W] contiguous; labels, areas, parent int32 [B, H, W];
// tile_roots int32 [B, ceil(H * W / 1024)]. Returns a cudaError_t.
extern "C" int vp_connected_components(const void* mask, void* labels, void* areas,
                                       void* parent, void* tile_roots, int B, int H, int W,
                                       void* stream) {
  const int hw = H * W;
  if (B == 0 || hw == 0) return 0;
  const int tiles = (hw + TILE - 1) / TILE;
  const dim3 grid(tiles, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const uint8_t*>(mask);
  auto lab = static_cast<int*>(labels);
  auto ar = static_cast<int*>(areas);
  auto par = static_cast<int*>(parent);
  auto tr = static_cast<int*>(tile_roots);
  cc_init<<<grid, TILE, 0, s>>>(m, par, ar, hw);
  cc_merge<<<grid, TILE, 0, s>>>(m, par, H, W);
  cc_flatten<<<grid, TILE, 0, s>>>(par, ar, tr, hw);
  cc_scan_tiles<<<dim3(1, B), TILE, 0, s>>>(tr, tiles);
  cc_rank<<<grid, TILE, 0, s>>>(par, tr, lab, hw);
  cc_write<<<grid, TILE, 0, s>>>(par, lab, ar, hw);
  return static_cast<int>(cudaGetLastError());
}
