// Multilevel FPN RoIAlign backward (feature gradient) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_slab_grad_group`
// (detectorch_tpu/ops/pallas/roi_align_kernel.py:489, pallas_call at :599).
// That kernel sorts rois by 64-row band outside the kernel, walks the bands
// in order on one TensorCore and carries a 128-row VMEM accumulator from
// band to band; rois whose footprint overflows the 64x64 slab get the
// gradient of a clamped forward. Here every roi is exact, and the sequential
// band sweep becomes a parallel sweep over output tiles, each fed by a list
// of the rois that reach it, built on the device:
//
//   1. `roi_tile_count_kernel`, one warp per roi, writes the roi's range of
//      kTile x kTile tiles of its level and image that its bilinear taps can
//      reach (one pixel of slack on each side) and adds one to the count of
//      every tile in it (atomics on counts only);
//   2. `tile_starts_kernel`, one block, scans the counts into each tile's
//      first list slot;
//   3. `roi_tile_fill_kernel`, one warp per roi, writes the roi into the list
//      of every tile of its range, at a slot taken with an atomic: the list
//      holds the right rois, in an order that varies from launch to launch;
//   4. `roi_align_bwd_kernel`, one block per tile over all channels, sorts
//      its list ascending in shared memory (in place in device memory past
//      kSortCap rois), then adds each roi's contribution to the tile's
//      pixels, which it alone owns.
//
// So every pixel sums its rois in ascending roi order: no atomics on
// gradient values, no host sync, no sort outside the kernels, and the
// gradient is bitwise equal from launch to launch. Every block writes its
// whole tile, so tiles no roi reaches come out zero and the output needs no
// memset. The scratch (ranges, counts, starts, lists) is sized by the
// wrapper from shapes alone: a roi reaches at most the tiles of one image of
// one level.
//
// Per batch of kBatch rois the block builds the separable weights of its
// tile once, one thread per (roi, axis, bin): Ky[ph][y] = sum over the
// bin's row samples of the bilinear weight on row y, times 1/count, and
// Kx[pw][x] likewise, with a bit mask of the tile's rows (columns) where each
// bin's weight is not zero; two barriers per batch. A thread owns one row of
// the tile and one 4-channel vector, 8 pixels in all, so a block of 512
// threads covers 256 channels (larger C loops over 256-channel passes). Per
// roi a warp (one row y) takes the bins ph whose Ky is not zero on its row
// and the bins pw with any Kx on the tile; for each column of bins pw (two
// in flight) it folds h = sum over ph of Ky[ph][y] * g[ph][pw] from 16-byte
// loads of g, then adds Kx[pw][x] * h to its 8 pixels, skipping a half tile
// where Kx is zero. The sums are fp32 (fmaf, so nvcc has no contraction left
// to choose) and are rounded once, to fp32 or bf16, at the store.
//
// What bounds it: bytes. At batch 8, 832x1344, C = 256 the box call reads g
// (4096 x 7 x 7 x 256 fp32, 205.5 MB) and writes the gradient pyramid (380 MB
// in bf16): 0.175 ms at 3.35 TB/s. Its fp32 FMAs take a fraction of that at
// the 67 TFLOP/s of the CUDA cores, so tensor cores would buy nothing (and
// TF32 would break the fp32 parity). The first design had every block scan
// all R roi ranges (3.1 GB of L2 reads and two barriers per 256 rois for the
// box call) and every 64-channel block rebuild the weights with two barriers
// per roi: 1.83 ms on an H100 80GB HBM3 at 700 W. Here a block reads only its
// own list and builds the weights once per tile and batch. Measured on that
// card with tools/bwd_variants.py (box call, bf16): as built, 0.400 ms; capped
// at one block of 512 threads per SM (87 registers, no spill) instead of two
// (64, 12 bytes of spill), 0.612 ms; with the accumulation left out (lists,
// weights and the write of zeros), 0.15-0.17 ms. Slower in earlier tries: a
// predicated FMA per column and bin in place of the folded columns (issue
// bound: most columns of a bin have zero weight), and a software prefetch of
// the next roi's bins. Not done: staging g in shared memory with
// cp.async in a ring (the live bins of one small roi at 14x14 are 196 KB of
// fp32 at C = 256, more than a block's shared memory), tensor cores, and
// splitting a long list over several blocks: one block sums a tile's whole
// list, so 3000 rois on one P2 tile take 5.0 ms at 7x7 and 10.9 ms at
// 14x14, where sampled training rois put a few hundred on a tile.
//
// The sample geometry uses the _rn intrinsics as the forward kernel does, so
// sample coordinates round exactly as the plain PyTorch version's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTile = 8;                    // tile: kTile x kTile pixels
constexpr int kThreads = 512;               // one thread per (tile row, 4-channel vector)
constexpr int kVecs = kThreads / kTile;     // 64 vectors: 256 channels per pass
constexpr int kChunk = 4 * kVecs;
constexpr int kMaxPooled = 16;              // bins per axis (ballots over a warp's lanes)
constexpr int kBatch = kThreads / (2 * kMaxPooled);  // rois whose weights one pass builds
constexpr int kSortCap = 2048;              // longer lists are sorted in device memory
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  void* ptr[kMaxLevels];  // gradient of each level, (B, H, W, C)
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
  int tiles_x[kMaxLevels];          // tiles along a row
  int tiles_per_image[kMaxLevels];
  int tile_base[kMaxLevels + 1];    // first tile id of each level; [count] = all tiles
  int count;
};

struct RoiGeometry {
  float start_h, start_w, bin_h, bin_w, inv_count;
  int grid_h, grid_w;
};

// The roi's geometry on its level, with the rules and rounding of the
// forward kernel (roi_align_fwd.cu) and of ops/roi_align.roi_geometry.
__device__ __forceinline__ RoiGeometry roi_geometry(const float* rois, int r, float s,
                                                    int pooled_h, int pooled_w,
                                                    int sampling_ratio, int max_grid) {
  const float4 box = *reinterpret_cast<const float4*>(rois + 4 * static_cast<size_t>(r));
  RoiGeometry geo;
  geo.start_w = __fmul_rn(box.x, s);
  geo.start_h = __fmul_rn(box.y, s);
  const float roi_w = fmaxf(__fsub_rn(__fmul_rn(box.z, s), geo.start_w), 1.f);
  const float roi_h = fmaxf(__fsub_rn(__fmul_rn(box.w, s), geo.start_h), 1.f);
  geo.bin_h = __fdiv_rn(roi_h, static_cast<float>(pooled_h));
  geo.bin_w = __fdiv_rn(roi_w, static_cast<float>(pooled_w));
  geo.grid_h = sampling_ratio;
  geo.grid_w = sampling_ratio;
  if (sampling_ratio <= 0) {  // adaptive: ceil(roi / pooled) clipped to [1, max_grid]
    geo.grid_h = static_cast<int>(fminf(fmaxf(ceilf(geo.bin_h), 1.f), static_cast<float>(max_grid)));
    geo.grid_w = static_cast<int>(fminf(fmaxf(ceilf(geo.bin_w), 1.f), static_cast<float>(max_grid)));
  }
  geo.inv_count = __fdiv_rn(1.f, static_cast<float>(geo.grid_h * geo.grid_w));
  return geo;
}

// Sample coordinate start + p*bin + (i+0.5)*bin/grid, rounded step by step.
__device__ __forceinline__ float sample_coord(float start, int p, float bin, int i, int grid) {
  return __fadd_rn(__fadd_rn(start, __fmul_rn(static_cast<float>(p), bin)),
                   __fdiv_rn(__fmul_rn(static_cast<float>(i) + 0.5f, bin),
                             static_cast<float>(grid)));
}

// Bilinear weights that the `grid` samples of bin p put on rows org ..
// org + kTile - 1 (of `size`), each row summed in sample order: samples
// outside [-1, size] add nothing; a sample clamped onto the last row gives
// both of its taps to that row; rows at or past `size` get nothing.
__device__ __forceinline__ void axis_weights(float start, float bin, int grid, int p, int org,
                                             int size, float (&w)[kTile]) {
#pragma unroll
  for (int t = 0; t < kTile; ++t) w[t] = 0.f;
  const float fsize = static_cast<float>(size);
  for (int i = 0; i < grid; ++i) {
    float y = sample_coord(start, p, bin, i, grid);
    if (y < -1.f || y > fsize) continue;
    y = fminf(fmaxf(y, 0.f), fsize - 1.f);
    const int y0 = static_cast<int>(floorf(y));
    const int y1 = min(y0 + 1, size - 1);
    const float ly = __fsub_rn(y, static_cast<float>(y0));
    const float hy = __fsub_rn(1.f, ly);
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      if (org + t == y0) w[t] = __fadd_rn(w[t], hy);
      if (org + t == y1) w[t] = __fadd_rn(w[t], ly);
    }
  }
}

// Tiles [lo, hi] along one axis that the roi's taps can reach, packed as
// (lo << 16) | hi: rows from the first sample's floor to the last sample's
// floor + 1, clamped, with one row of slack on each side.
__device__ __forceinline__ int tile_span(float start, float bin, int grid, int pooled, int size) {
  const float top = static_cast<float>(size - 1);
  const float first = fminf(fmaxf(sample_coord(start, 0, bin, 0, grid), 0.f), top);
  const float last = fminf(fmaxf(sample_coord(start, pooled - 1, bin, grid - 1, grid), 0.f), top);
  const int lo = max(static_cast<int>(floorf(first)) - 1, 0);
  const int hi = min(static_cast<int>(floorf(last)) + 2, size - 1);
  return ((lo / kTile) << 16) | (hi / kTile);
}

constexpr int kNoSpan = 1 << 16;  // lo 1, hi 0: no tile

__device__ __forceinline__ int span_len(int span) {
  return max((span & 0xffff) - (span >> 16) + 1, 0);
}

// Calls fn(tile) for tiles lane, lane + 32, ... of a roi's range q: q.x =
// the first tile of its level and image, q.y and q.z the packed row and
// column spans, q.w = tiles along a row of its level.
template <typename Fn>
__device__ __forceinline__ void for_each_tile(const int4 q, int lane, Fn fn) {
  const int nx = span_len(q.z);
  const int n = span_len(q.y) * nx;
  for (int i = lane; i < n; i += 32) {
    const int ty = (q.y >> 16) + i / nx;
    const int tx = (q.z >> 16) + i % nx;
    fn(q.x + ty * q.w + tx);
  }
}

__global__ void roi_tile_count_kernel(const Levels lv, const float* __restrict__ rois,
                                      const int* __restrict__ batch_idx,
                                      const int* __restrict__ levels, int num_rois,
                                      int num_images, int pooled_h, int pooled_w,
                                      int sampling_ratio, int max_grid,
                                      int4* __restrict__ ranges, int* __restrict__ counts) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= num_rois) return;
  const int l = levels[r];
  const int b = batch_idx[r];
  int4 q = make_int4(0, kNoSpan, kNoSpan, 1);  // reaches no tile
  if (l >= 0 && l < lv.count && b >= 0 && b < num_images) {
    const RoiGeometry geo = roi_geometry(rois, r, lv.scale[l], pooled_h, pooled_w,
                                         sampling_ratio, max_grid);
    q = make_int4(lv.tile_base[l] + b * lv.tiles_per_image[l],
                  tile_span(geo.start_h, geo.bin_h, geo.grid_h, pooled_h, lv.height[l]),
                  tile_span(geo.start_w, geo.bin_w, geo.grid_w, pooled_w, lv.width[l]),
                  lv.tiles_x[l]);
  }
  if (lane == 0) ranges[r] = q;
  for_each_tile(q, lane, [&](int t) { atomicAdd(counts + t, 1); });
}

// starts[t] = counts[0] + ... + counts[t - 1], for t = 0 .. num_tiles; one block.
__global__ void __launch_bounds__(kScanThreads) tile_starts_kernel(const int* __restrict__ counts,
                                                                   int num_tiles,
                                                                   int* __restrict__ starts) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int per = (num_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, num_tiles);
  const int hi = min(lo + per, num_tiles);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += v;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    starts[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == kScanThreads - 1) starts[num_tiles] = run;
}

// Writes each roi into its tiles' lists; leaves every count at zero.
__global__ void roi_tile_fill_kernel(const int4* __restrict__ ranges, int num_rois,
                                     const int* __restrict__ starts, int* __restrict__ counts,
                                     int* __restrict__ lists) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= num_rois) return;
  for_each_tile(ranges[r], threadIdx.x & 31,
                [&](int t) { lists[starts[t] + atomicSub(counts + t, 1) - 1] = r; });
}

// Sorts a[0, n) ascending with the block's threads: a bitonic network over
// the next power of two whose comparators all put the smaller value first
// (each merge starts by comparing mirrored pairs), so slots at or past n
// act as +infinity and are never touched. Ends with a barrier.
__device__ void block_sort(int* a, int n) {
  int size = 1;
  while (size < n) size <<= 1;
  for (int k = 2; k <= size; k <<= 1) {
    for (int d = k >> 1; d > 0; d >>= 1) {
      for (int i = threadIdx.x; i < size / 2; i += kThreads) {
        const int blk = i / d;
        const int off = i - blk * d;
        const int lo = 2 * d * blk + off;
        const int hi = d == (k >> 1) ? 2 * d * blk + 2 * d - 1 - off : lo + d;
        if (hi < n) {
          const int x = a[lo];
          const int y = a[hi];
          if (x > y) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&lo);
  q.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

__device__ __forceinline__ void fma4(float4& h, float a, const float4 v) {
  h.x = fmaf(a, v.x, h.x);
  h.y = fmaf(a, v.y, h.y);
  h.z = fmaf(a, v.z, h.z);
  h.w = fmaf(a, v.w, h.w);
}

// acc[x] += kx[x] * h over the tile's columns, one half of the tile at a
// time, skipping a half where the bin's Kx is zero.
__device__ __forceinline__ void add_column_bin(float (&acc)[kTile][4], const float* kx,
                                               unsigned cols, const float4 h) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if ((cols >> (4 * half)) & 0xfu) {
      const float4 w = reinterpret_cast<const float4*>(kx)[half];
      const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* a = acc[4 * half + i];
        a[0] = fmaf(ws[i], h.x, a[0]);
        a[1] = fmaf(ws[i], h.y, a[1]);
        a[2] = fmaf(ws[i], h.z, a[2]);
        a[3] = fmaf(ws[i], h.w, a[3]);
      }
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2) roi_align_bwd_kernel(
    const Levels lv, const float* __restrict__ g, const float* __restrict__ rois,
    const int* __restrict__ starts, int* __restrict__ lists, int channels, int pooled_h,
    int pooled_w, int sampling_ratio, int max_grid) {
  __shared__ float ky[kBatch][kMaxPooled][kTile];
  __shared__ __align__(16) float kx[kBatch][kMaxPooled][kTile];  // read as float4
  __shared__ unsigned ybits[kBatch][kMaxPooled];  // rows where each bin's Ky is not zero
  __shared__ unsigned xbits[kBatch][kMaxPooled];  // columns where each bin's Kx is not zero
  __shared__ int sorted[kSortCap];

  const int tile = blockIdx.x;
  int l = 0;
  while (l + 1 < lv.count && tile >= lv.tile_base[l + 1]) ++l;
  const int local = tile - lv.tile_base[l];
  const int b = local / lv.tiles_per_image[l];
  const int t_img = local - b * lv.tiles_per_image[l];
  const int ty = t_img / lv.tiles_x[l];
  const int tx = t_img - ty * lv.tiles_x[l];
  const int y_org = ty * kTile;
  const int x_org = tx * kTile;
  const int height = lv.height[l];
  const int width = lv.width[l];
  const float s = lv.scale[l];

  // the tile's rois, ascending
  const int begin = starts[tile];
  const int n = starts[tile + 1] - begin;
  int* order = lists + begin;
  if (n <= kSortCap) {
    for (int i = threadIdx.x; i < n; i += kThreads) sorted[i] = order[i];
    order = sorted;
  }
  __syncthreads();
  block_sort(order, n);

  const int lane = threadIdx.x & 31;
  const int row = threadIdx.x / kVecs;  // the same for the whole warp
  const int vec = threadIdx.x % kVecs;
  const int n_weights = pooled_h + pooled_w;
  const size_t g_roi = static_cast<size_t>(pooled_h) * pooled_w * channels;
  OutT* out = static_cast<OutT*>(lv.ptr[l]) + static_cast<size_t>(b) * height * width * channels;

  for (int c_base = 0; c_base < channels; c_base += kChunk) {
    const int c = c_base + 4 * vec;
    const bool active = c < channels;
    float acc[kTile][4];
#pragma unroll
    for (int x = 0; x < kTile; ++x)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[x][j] = 0.f;

    for (int base = 0; base < n; base += kBatch) {
      const int nk = min(kBatch, n - base);
      __syncthreads();  // the previous batch's weights are no longer read
      if (threadIdx.x < nk * n_weights) {
        const int k = threadIdx.x / n_weights;
        const int j = threadIdx.x - k * n_weights;
        const RoiGeometry geo = roi_geometry(rois, order[base + k], s, pooled_h, pooled_w,
                                             sampling_ratio, max_grid);
        float w[kTile];
        unsigned bits = 0;
        if (j < pooled_h) {
          axis_weights(geo.start_h, geo.bin_h, geo.grid_h, j, y_org, height, w);
#pragma unroll
          for (int t = 0; t < kTile; ++t) {
            w[t] = __fmul_rn(w[t], geo.inv_count);
            ky[k][j][t] = w[t];
            bits |= static_cast<unsigned>(w[t] != 0.f) << t;
          }
          ybits[k][j] = bits;
        } else {
          const int p = j - pooled_h;
          axis_weights(geo.start_w, geo.bin_w, geo.grid_w, p, x_org, width, w);
#pragma unroll
          for (int t = 0; t < kTile; ++t) {
            kx[k][p][t] = w[t];
            bits |= static_cast<unsigned>(w[t] != 0.f) << t;
          }
          xbits[k][p] = bits;
        }
      }
      __syncthreads();  // weights ready

      for (int k = 0; k < nk; ++k) {
        const unsigned ph_live =
            __ballot_sync(kFull, lane < pooled_h && ((ybits[k][lane] >> row) & 1u));
        const unsigned pw_live = __ballot_sync(kFull, lane < pooled_w && xbits[k][lane] != 0u);
        if (!active || !ph_live || !pw_live) continue;
        const float* gr = g + static_cast<size_t>(order[base + k]) * g_roi + c;
        unsigned pws = pw_live;
        while (pws) {  // two columns of bins in flight
          const int pw0 = __ffs(pws) - 1;
          pws &= pws - 1;
          const int pw1 = pws ? __ffs(pws) - 1 : pw0;
          if (pws) pws &= pws - 1;
          // h = sum over the bins ph of this row of Ky[ph][row] * g[ph][pw]
          float4 h0 = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 h1 = h0;
          for (unsigned phs = ph_live; phs; phs &= phs - 1) {
            const int ph = __ffs(phs) - 1;
            const float* gp = gr + static_cast<size_t>(ph) * pooled_w * channels;
            const float4 v0 = __ldg(reinterpret_cast<const float4*>(gp + pw0 * channels));
            const float4 v1 = __ldg(reinterpret_cast<const float4*>(gp + pw1 * channels));
            const float a = ky[k][ph][row];
            fma4(h0, a, v0);
            fma4(h1, a, v1);
          }
          add_column_bin(acc, kx[k][pw0], xbits[k][pw0], h0);
          if (pw1 != pw0) add_column_bin(acc, kx[k][pw1], xbits[k][pw1], h1);
        }
      }
    }

    const int y = y_org + row;
    if (active && y < height) {
#pragma unroll
      for (int x = 0; x < kTile; ++x)
        if (x_org + x < width)
          store4(out + (static_cast<size_t>(y) * width + x_org + x) * channels + c, acc[x]);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Level tables are host arrays of
// `num_levels` entries (`tile_base` has num_levels + 1, the last = all
// tiles); all other pointers are device pointers. Launches the four kernels
// on `stream` and returns the first CUDA error (0 on success).
//   out_dtype: 0 = float32 gradients, 1 = bfloat16 gradients.
//   g (R, PH, PW, C) fp32; rois (R, 4) fp32; batch_idx, levels (R,) int32;
//   scratch: `scratch_ints` int32, 16-byte aligned, at least
//   4 * R + 2 * tiles + 1 + R * max(tiles_per_image).
extern "C" int roi_align_bwd(int device, int out_dtype, int num_levels, void* const* level_ptrs,
                             const int* level_heights, const int* level_widths,
                             const float* level_scales, const int* level_tiles_x,
                             const int* level_tiles_per_image, const int* tile_base,
                             int num_images, const float* g, const float* rois,
                             const int* batch_idx, const int* levels, int num_rois,
                             void* scratch, long long scratch_ints, int channels, int pooled_h,
                             int pooled_w, int sampling_ratio, int max_grid, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || num_rois < 0 || num_images < 1 ||
      pooled_h < 1 || pooled_w < 1 || pooled_h > kMaxPooled || pooled_w > kMaxPooled ||
      channels % 8 != 0 || channels < 8 || (out_dtype != 0 && out_dtype != 1) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Levels lv;
  lv.count = num_levels;
  long long max_tiles = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < num_levels;
    lv.ptr[i] = used ? level_ptrs[i] : nullptr;
    lv.height[i] = used ? level_heights[i] : 0;
    lv.width[i] = used ? level_widths[i] : 0;
    lv.scale[i] = used ? level_scales[i] : 0.f;
    lv.tiles_x[i] = used ? level_tiles_x[i] : 1;
    lv.tiles_per_image[i] = used ? level_tiles_per_image[i] : 1;
    if (used && level_tiles_per_image[i] > max_tiles) max_tiles = level_tiles_per_image[i];
  }
  for (int i = 0; i <= kMaxLevels; ++i)
    lv.tile_base[i] = tile_base[i < num_levels ? i : num_levels];
  const int num_tiles = tile_base[num_levels];
  if (num_tiles < 1 ||
      scratch_ints < 4LL * num_rois + 2LL * num_tiles + 1 + num_rois * max_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  int* base = static_cast<int*>(scratch);
  int4* ranges = reinterpret_cast<int4*>(base);
  int* counts = base + 4LL * num_rois;
  int* starts = counts + num_tiles;
  int* lists = starts + num_tiles + 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(num_tiles), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int roi_blocks = static_cast<int>((32LL * num_rois + 255) / 256);  // a warp per roi
  if (num_rois > 0) {
    roi_tile_count_kernel<<<roi_blocks, 256, 0, st>>>(lv, rois, batch_idx, levels, num_rois,
                                                       num_images, pooled_h, pooled_w,
                                                       sampling_ratio, max_grid, ranges, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_starts_kernel<<<1, kScanThreads, 0, st>>>(counts, num_tiles, starts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rois > 0) {
    roi_tile_fill_kernel<<<roi_blocks, 256, 0, st>>>(ranges, num_rois, starts, counts, lists);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (out_dtype == 1)
    roi_align_bwd_kernel<__nv_bfloat16><<<num_tiles, kThreads, 0, st>>>(
        lv, g, rois, starts, lists, channels, pooled_h, pooled_w, sampling_ratio, max_grid);
  else
    roi_align_bwd_kernel<float><<<num_tiles, kThreads, 0, st>>>(
        lv, g, rois, starts, lists, channels, pooled_h, pooled_w, sampling_ratio, max_grid);
  return static_cast<int>(cudaGetLastError());
}
