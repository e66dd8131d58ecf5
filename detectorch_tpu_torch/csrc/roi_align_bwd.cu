// Multilevel FPN RoIAlign backward (feature gradient) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_slab_grad_group`
// (detectorch_tpu/ops/pallas/roi_align_kernel.py:489, pallas_call at :599).
// That kernel sorts rois by 64-row band outside the kernel, walks the bands
// in order on one TensorCore and carries a 128-row VMEM accumulator from
// band to band; rois whose footprint overflows the 64x64 slab get the
// gradient of a clamped forward. Here every roi is exact, and the sequential
// band sweep becomes a parallel sweep over output tiles with no sort at all:
//
//   1. `roi_tile_ranges_kernel`, one thread per roi, writes the roi's
//      (level, image) and the range of kTile x kTile tiles of that level its
//      bilinear taps can reach (one pixel of slack on each side);
//   2. `roi_align_bwd_kernel`, one block per (tile, 64-channel chunk), scans
//      the rois in ascending order, 256 at a time, keeps those whose range
//      covers its tile (warp ballots compact them in order), and adds each
//      one's contribution to the tile's pixels, which it alone owns.
//
// So every pixel sums its rois in ascending roi order: no atomics, no
// second pass, and the gradient is bitwise equal from launch to launch.
// Every block writes its whole tile, so tiles no roi reaches come out zero
// and the output needs no memset.
//
// Per roi the block builds the separable weights of its tile in shared
// memory: Ky[ph][y] = sum over the bin's row samples of the bilinear weight
// on row y, times 1/count, and Kx[pw][x] likewise (double-buffered, so two
// barriers per roi suffice). Each warp reads off the bins with a non-zero
// weight on the tile, and the block stages those bins of g (that channel
// chunk) in shared memory with independent 16-byte loads. A thread owns four
// pixels of the tile and one 4-channel vector, and adds
// Ky[ph][y] * Kx[pw][x] * g[roi, ph, pw, c:c+4] over the bins whose weights
// on its pixel are not zero (one or two per axis). The sums are fp32 (fmaf,
// so nvcc has no contraction left to choose) and are rounded once, to fp32
// or bf16, at the store.
//
// What bounds it: the write of the gradient pyramid (B*sum(H_l*W_l)*C
// elements, 380 MB in bf16 at batch 8, 832x1344, C = 256), the reads of g,
// and the scan of the roi ranges (16 bytes per roi per block, from L2).
// Tuning (tensor cores for Ky^T g Kx, a smarter roi scan) is left for later.
//
// The sample geometry uses the _rn intrinsics as the forward kernel does, so
// sample coordinates round exactly as the plain PyTorch version's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTile = 8;                                   // tile: kTile x kTile pixels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                                 // channels per block
constexpr int kVecs = kChunk / 4;                          // float4 vectors per pixel
constexpr int kPixStride = kThreads / kVecs;               // 16
constexpr int kPixPerThread = kTile * kTile / kPixStride;  // 4
constexpr int kMaxPooled = 16;  // (PH + PW) * kTile weights fit one pass of the block

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

// Bilinear weight that the `grid` samples of bin p put on row `row` (of
// `size`): samples outside [-1, size] add nothing; a sample clamped onto the
// last row gives both of its taps to that row.
__device__ __forceinline__ float axis_weight(float start, float bin, int grid, int p, int row,
                                             int size) {
  if (row >= size) return 0.f;
  const float fsize = static_cast<float>(size);
  float w = 0.f;
  for (int i = 0; i < grid; ++i) {
    float y = sample_coord(start, p, bin, i, grid);
    if (y < -1.f || y > fsize) continue;
    y = fminf(fmaxf(y, 0.f), fsize - 1.f);
    const int y0 = static_cast<int>(floorf(y));
    const int y1 = min(y0 + 1, size - 1);
    const float ly = __fsub_rn(y, static_cast<float>(y0));
    const float hy = __fsub_rn(1.f, ly);
    if (row == y0) w = __fadd_rn(w, hy);
    if (row == y1) w = __fadd_rn(w, ly);
  }
  return w;
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

__global__ void roi_tile_ranges_kernel(const Levels lv, const float* __restrict__ rois,
                                       const int* __restrict__ batch_idx,
                                       const int* __restrict__ levels, int num_rois,
                                       int num_images, int pooled_h, int pooled_w,
                                       int sampling_ratio, int max_grid, int4* __restrict__ ranges) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rois) return;
  const int l = levels[r];
  const int b = batch_idx[r];
  if (l < 0 || l >= lv.count || b < 0 || b >= num_images) {  // reaches no tile
    ranges[r] = make_int4(-1, 0, 0, 0);
    return;
  }
  const RoiGeometry geo = roi_geometry(rois, r, lv.scale[l], pooled_h, pooled_w, sampling_ratio,
                                       max_grid);
  ranges[r] = make_int4(l * num_images + b,
                        tile_span(geo.start_h, geo.bin_h, geo.grid_h, pooled_h, lv.height[l]),
                        tile_span(geo.start_w, geo.bin_w, geo.grid_w, pooled_w, lv.width[l]), 0);
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

// Bins p (< pooled) whose weight row w[p][0..kTile) is not all zero, as a
// bit mask; every warp computes it from shared memory.
__device__ __forceinline__ unsigned live_bins(const float* w, int pooled, int lane) {
  bool live = false;
  if (lane < pooled) {
#pragma unroll
    for (int t = 0; t < kTile; ++t) live |= w[lane * kTile + t] != 0.f;
  }
  return __ballot_sync(0xffffffffu, live);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) roi_align_bwd_kernel(
    const Levels lv, const float* __restrict__ g, const float* __restrict__ rois,
    const int4* __restrict__ ranges, int num_rois, int num_images, int channels, int pooled_h,
    int pooled_w, int sampling_ratio, int max_grid) {
  extern __shared__ float4 gs[];  // the tile's bins of g[roi, :, :, chunk]: [bin][kVecs]
  __shared__ float ky[2][kMaxPooled * kTile];
  __shared__ float kx[2][kMaxPooled * kTile];
  __shared__ int list[kThreads];
  __shared__ int warp_hits[kWarps];

  const int tile = blockIdx.x;
  int l = 0;
  while (l + 1 < lv.count && tile >= lv.tile_base[l + 1]) ++l;
  const int local = tile - lv.tile_base[l];
  const int b = local / lv.tiles_per_image[l];
  const int t_img = local - b * lv.tiles_per_image[l];
  const int ty = t_img / lv.tiles_x[l];
  const int tx = t_img - ty * lv.tiles_x[l];
  const int key = l * num_images + b;
  const int y_org = ty * kTile;
  const int x_org = tx * kTile;
  const int height = lv.height[l];
  const int width = lv.width[l];
  const float s = lv.scale[l];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int vec = threadIdx.x % kVecs;
  const int pix0 = threadIdx.x / kVecs;
  const int c0 = blockIdx.y * kChunk + vec * 4;
  const size_t g_roi = static_cast<size_t>(pooled_h) * pooled_w * channels;
  const int n_weights = (pooled_h + pooled_w) * kTile;

  float acc[kPixPerThread][4];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  int parity = 0;
  for (int base = 0; base < num_rois; base += kThreads) {
    // this tile's rois among the next kThreads, in ascending order
    const int r_scan = base + threadIdx.x;
    bool hit = false;
    if (r_scan < num_rois) {
      const int4 q = ranges[r_scan];
      hit = q.x == key && (q.y >> 16) <= ty && ty <= (q.y & 0xffff) && (q.z >> 16) <= tx &&
            tx <= (q.z & 0xffff);
    }
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(hits);
    __syncthreads();
    int offset = 0;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      offset += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (hit) list[offset + __popc(hits & ((1u << lane) - 1u))] = r_scan;
    __syncthreads();

    for (int i = 0; i < total; ++i, parity ^= 1) {
      const int r = list[i];
      const RoiGeometry geo = roi_geometry(rois, r, s, pooled_h, pooled_w, sampling_ratio,
                                           max_grid);
      float* wy = ky[parity];
      float* wx = kx[parity];
      for (int e = threadIdx.x; e < n_weights; e += kThreads) {
        if (e < pooled_h * kTile) {
          const int p = e / kTile;
          wy[e] = __fmul_rn(
              axis_weight(geo.start_h, geo.bin_h, geo.grid_h, p, y_org + e - p * kTile, height),
              geo.inv_count);
        } else {
          const int e2 = e - pooled_h * kTile;
          const int p = e2 / kTile;
          wx[e2] = axis_weight(geo.start_w, geo.bin_w, geo.grid_w, p, x_org + e2 - p * kTile,
                               width);
        }
      }
      __syncthreads();  // weights ready; the previous roi's g is no longer read

      const unsigned ph_live = live_bins(wy, pooled_h, lane);
      const unsigned pw_live = live_bins(wx, pooled_w, lane);
      const int ph0 = ph_live ? __ffs(ph_live) - 1 : 0;
      const int nph = ph_live ? 32 - __clz(ph_live) - ph0 : 0;
      const int pw0 = pw_live ? __ffs(pw_live) - 1 : 0;
      const int npw = pw_live ? 32 - __clz(pw_live) - pw0 : 0;
      const float* gr = g + static_cast<size_t>(r) * g_roi;
      for (int e = threadIdx.x; e < nph * npw * kVecs; e += kThreads) {
        const int bin = e / kVecs;
        const int c = blockIdx.y * kChunk + (e - bin * kVecs) * 4;
        const int ph = ph0 + bin / npw;
        const int pw = pw0 + bin - (bin / npw) * npw;
        gs[e] = c < channels ? __ldg(reinterpret_cast<const float4*>(
                                   gr + (static_cast<size_t>(ph) * pooled_w + pw) * channels + c))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();  // g staged

      if (c0 < channels) {
#pragma unroll
        for (int k = 0; k < kPixPerThread; ++k) {
          const int pix = pix0 + k * kPixStride;
          const int py = pix / kTile;
          const int px = pix - py * kTile;
          for (int bh = 0; bh < nph; ++bh) {
            const float a = wy[(ph0 + bh) * kTile + py];
            if (a == 0.f) continue;
            for (int bw = 0; bw < npw; ++bw) {
              const float bwt = wx[(pw0 + bw) * kTile + px];
              if (bwt == 0.f) continue;
              const float w = __fmul_rn(a, bwt);
              const float4 v = gs[(bh * npw + bw) * kVecs + vec];
              acc[k][0] = fmaf(w, v.x, acc[k][0]);
              acc[k][1] = fmaf(w, v.y, acc[k][1]);
              acc[k][2] = fmaf(w, v.z, acc[k][2]);
              acc[k][3] = fmaf(w, v.w, acc[k][3]);
            }
          }
        }
      }
    }
  }

  if (c0 >= channels) return;
  OutT* out = static_cast<OutT*>(lv.ptr[l]) +
              static_cast<size_t>(b) * height * width * channels + c0;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int pix = pix0 + k * kPixStride;
    const int y = y_org + pix / kTile;
    const int x = x_org + pix % kTile;
    if (y < height && x < width)
      store4(out + (static_cast<size_t>(y) * width + x) * channels, acc[k]);
  }
}

template <typename OutT>
cudaError_t launch(const Levels& lv, int num_tiles, const float* g, const float* rois,
                   const int4* ranges, int num_rois, int num_images, int channels, int pooled_h,
                   int pooled_w, int sampling_ratio, int max_grid, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(pooled_h) * pooled_w * kVecs * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(roi_align_bwd_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(num_tiles),
                  static_cast<unsigned>((channels + kChunk - 1) / kChunk));
  roi_align_bwd_kernel<OutT><<<grid, kThreads, smem, st>>>(
      lv, g, rois, ranges, num_rois, num_images, channels, pooled_h, pooled_w, sampling_ratio,
      max_grid);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Level tables are host arrays of
// `num_levels` entries (`tile_base` has num_levels + 1, the last = all
// tiles); all other pointers are device pointers. Launches both kernels on
// `stream` and returns the first CUDA error (0 on success).
//   out_dtype: 0 = float32 gradients, 1 = bfloat16 gradients.
//   g (R, PH, PW, C) fp32; rois (R, 4) fp32; batch_idx, levels (R,) int32;
//   ranges: scratch of max(R, 1) int4.
extern "C" int roi_align_bwd(int device, int out_dtype, int num_levels, void* const* level_ptrs,
                             const int* level_heights, const int* level_widths,
                             const float* level_scales, const int* level_tiles_x,
                             const int* level_tiles_per_image, const int* tile_base,
                             int num_images, const float* g, const float* rois,
                             const int* batch_idx, const int* levels, int num_rois,
                             void* ranges, int channels, int pooled_h, int pooled_w,
                             int sampling_ratio, int max_grid, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || num_rois < 0 || num_images < 1 ||
      pooled_h < 1 || pooled_w < 1 || pooled_h > kMaxPooled || pooled_w > kMaxPooled ||
      channels % 8 != 0 || channels < 8 || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Levels lv;
  lv.count = num_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < num_levels;
    lv.ptr[i] = used ? level_ptrs[i] : nullptr;
    lv.height[i] = used ? level_heights[i] : 0;
    lv.width[i] = used ? level_widths[i] : 0;
    lv.scale[i] = used ? level_scales[i] : 0.f;
    lv.tiles_x[i] = used ? level_tiles_x[i] : 1;
    lv.tiles_per_image[i] = used ? level_tiles_per_image[i] : 1;
  }
  for (int i = 0; i <= kMaxLevels; ++i)
    lv.tile_base[i] = tile_base[i < num_levels ? i : num_levels];
  const int num_tiles = tile_base[num_levels];
  if (num_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int4* rg = static_cast<int4*>(ranges);
  if (num_rois > 0) {
    roi_tile_ranges_kernel<<<(num_rois + 255) / 256, 256, 0, st>>>(
        lv, rois, batch_idx, levels, num_rois, num_images, pooled_h, pooled_w, sampling_ratio,
        max_grid, rg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = out_dtype == 1
            ? launch<__nv_bfloat16>(lv, num_tiles, g, rois, rg, num_rois, num_images, channels,
                                    pooled_h, pooled_w, sampling_ratio, max_grid, st)
            : launch<float>(lv, num_tiles, g, rois, rg, num_rois, num_images, channels, pooled_h,
                            pooled_w, sampling_ratio, max_grid, st);
  return static_cast<int>(err);
}
