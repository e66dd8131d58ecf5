// Multilevel FPN RoIAlign forward for Hopper (sm_90a), caffe2 semantics.
//
// Replaces the Pallas TPU kernel `_roi_align_pallas_batched`
// (detectorch_tpu/ops/pallas/roi_align_kernel.py:164, pallas_call at :346).
// That kernel DMAs a 64x64 window of a padded, image-major level atlas into
// VMEM per roi and contracts it with two hat-weight matrices on the MXU; rois
// whose sampling footprint overflows the window come back flagged for an exact
// rerun. None of that carries over: here each roi's geometry is computed in
// the kernel with the rules of detectorch_tpu/ops/roi_align.py:44-76 and
// :379-412, and its taps are read straight from the NHWC features. The result
// is exact for every roi, whatever its size: there is no window to overflow.
//
// Layout: one block per (roi, slice of 32 channel vectors, group of at most
// 8 bin columns), one warp per bin column pw: a 7x7 roi is one block of 7
// warps per slice, a 14x14 roi two. A lane owns one channel vector (8 bf16
// or 4 fp32 channels, one 16-byte load) of its warp's column, so every
// branch below is uniform in a warp. The block starts by building the roi's
// tap plan in shared memory, one thread per bin and axis: for each bin row
// ph the distinct feature rows its samples' bilinear taps reach, ascending,
// each with its summed y weight, and for each bin column pw the distinct
// columns with their summed x weights (`axis_taps`; samples outside
// [-1, size] add nothing, and a sample clamped onto the last row gives both
// of its weights to that row). Then each warp walks the bin rows in order.
// For each feature row y of the plan it forms the x-interpolated row
// X(y) = sum over the column's taps of wx * F[y][x] once, from one 16-byte
// load per tap, and adds wy * X(y) into the bins of every bin row that
// reaches y: the two rows it formed last stay in registers, and a bin row
// only ever shares its first rows with the last rows of the bin row before
// it (samples ascend), so each row of the roi's footprint is loaded and
// interpolated once per bin column, not once per output row and sample.
// Each output element (bin, channel vector) is summed by one lane, in a
// fixed order: over the bin's rows ascending of wy * X(y), X(y) over its
// columns ascending, both in fp32 (fmaf), then times 1/count, and written
// once with a streaming (evict-first) store. The plain version sums the
// four taps of each sample, then the samples; the two orders round apart by
// a few ulp. sampling_ratio <= 2 (every FPN call) takes a specialisation
// with at most 4 taps per bin and axis, whose column taps sit in registers
// and whose loops unroll; the adaptive grid (sampling_ratio 0, up to
// max_grid per axis) reads its column taps from the plan.
//
// What bounds it: bytes, and the instructions between them. At batch 8,
// 832x1344, C = 256, bf16, the box call (8000 rois, 7x7) writes 401 MB of
// fp32 output and reads 238 MB of distinct feature bytes: 0.19 ms at
// 3.35 TB/s. The first design (one block per (roi, output row), a thread per
// (column, channel vector) looping over 4 taps x grid_h x grid_w samples with
// runtime bounds, every thread recomputing every sample's geometry) loaded
// 16 taps per bin and thread and took 0.388 ms on an NVIDIA H100 80GB HBM3
// at 700 W; this one takes 0.282 ms there (0.119 ms for the mask call, 864
// rois at 14x14, against 0.163). tools/fwd_variants.py splits it on that
// card: without the output write 0.171 ms, without the feature loads
// 0.139 ms, without both (plan, walk and FMAs alone) 0.10-0.11 ms. The
// write adds 0.11 ms to the rest (its 401 MB at the card's rate) and the
// loads 0.14 ms: they do not hide behind each other. At most 64 registers
// a thread (4 blocks of 8 warps per SM) is the best of 3, 4 and 5 blocks
// (5 spills); streaming stores beat ordinary ones by ~1.5%.
//
// The geometry uses the _rn intrinsics so nvcc cannot contract it into FMAs:
// sample coordinates then round exactly as the plain PyTorch version's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxWarps = 8;   // bin columns of a block
constexpr int kLanes = 32;     // channel vectors of a slice: one warp
constexpr int kTaps2 = 4;      // taps per bin and axis when sampling_ratio <= 2

struct Levels {
  const void* ptr[kMaxLevels];
  long long img_stride[kMaxLevels];  // elements between consecutive images
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
  int count;
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const uint4 q = load16(p);
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the top half of the fp32 of the same value
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 q = load16(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Sample coordinate start + p*bin + (i+0.5)*bin/grid, rounded step by step.
__device__ __forceinline__ float sample_coord(float start, int p, float bin, int i, int grid) {
  return __fadd_rn(__fadd_rn(start, __fmul_rn(static_cast<float>(p), bin)),
                   __fdiv_rn(__fmul_rn(static_cast<float>(i) + 0.5f, bin),
                             static_cast<float>(grid)));
}

// Adds weight w on tap t to the ascending list idx/wt of n taps. A new tap
// is never below the list's last two (samples ascend, and a sample's second
// tap is its first + 1 or, clamped, the same), so it matches one of them or
// goes at the end.
__device__ __forceinline__ int add_tap(int* idx, float* wt, int n, int t, float w) {
  if (n > 0 && idx[n - 1] == t) {
    wt[n - 1] = __fadd_rn(wt[n - 1], w);
    return n;
  }
  if (n > 1 && idx[n - 2] == t) {
    wt[n - 2] = __fadd_rn(wt[n - 2], w);
    return n;
  }
  idx[n] = t;
  wt[n] = w;
  return n + 1;
}

// The distinct taps (rows or columns of `size`) that the `grid` samples of
// bin p reach along one axis, ascending, with their summed bilinear weights:
// samples outside [-1, size] add nothing; a sample clamped onto the last row
// gives both of its weights to that row. Returns their number (<= 2 * grid).
__device__ int axis_taps(float start, float bin, int grid, int p, int size, int* idx, float* wt) {
  const float fsize = static_cast<float>(size);
  int n = 0;
  for (int i = 0; i < grid; ++i) {
    float y = sample_coord(start, p, bin, i, grid);
    if (y < -1.f || y > fsize) continue;
    y = fminf(fmaxf(y, 0.f), fsize - 1.f);
    const int y0 = static_cast<int>(floorf(y));
    const int y1 = min(y0 + 1, size - 1);
    const float ly = __fsub_rn(y, static_cast<float>(y0));
    const float hy = __fsub_rn(1.f, ly);
    n = add_tap(idx, wt, n, y0, hy);
    n = add_tap(idx, wt, n, y1, ly);
  }
  return n;
}

template <int V>
__device__ __forceinline__ void fma_row(float (&acc)[V], float w, const float (&x)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = fmaf(w, x[k], acc[k]);
}

template <int V>
__device__ __forceinline__ void store_cs(float* o, const float (&v)[V], float scale) {
#pragma unroll
  for (int k = 0; k < V; k += 4)
    __stcs(reinterpret_cast<float4*>(o + k),
           make_float4(v[k] * scale, v[k + 1] * scale, v[k + 2] * scale, v[k + 3] * scale));
}

// x = sum over the first N column taps of wx[j] * row[col[j]], all N loads
// issued before the first FMA.
template <typename T, int N>
__device__ __forceinline__ void interp_n(const T* row, const int (&col)[kTaps2],
                                         const float (&wx)[kTaps2], float (&x)[Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
  float v[N][V];
#pragma unroll
  for (int j = 0; j < N; ++j) Vec<T>::load(row + col[j], v[j]);
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = __fmul_rn(wx[0], v[0][k]);
#pragma unroll
  for (int j = 1; j < N; ++j) fma_row<V>(x, wx[j], v[j]);
}

// The x-interpolated feature row at `row`: from the column taps held in
// registers (kTaps == kTaps2, nc <= 4) or read from the plan (kTaps == 0).
template <typename T, int kTaps>
__device__ __forceinline__ void interp_row(const T* row, int nc, const int (&col)[kTaps2],
                                           const float (&wx)[kTaps2], const int* plan_col,
                                           const float* plan_wx, float (&x)[Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
  if (kTaps == kTaps2) {
    switch (nc) {
      case 4: interp_n<T, 4>(row, col, wx, x); return;
      case 3: interp_n<T, 3>(row, col, wx, x); return;
      case 2: interp_n<T, 2>(row, col, wx, x); return;
      case 1: interp_n<T, 1>(row, col, wx, x); return;
      default: break;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = 0.f;
  if (kTaps == 0) {
    for (int j = 0; j < nc; ++j) {
      float v[V];
      Vec<T>::load(row + plan_col[j], v);
      fma_row<V>(x, plan_wx[j], v);
    }
  }
}

template <typename T, int kTaps>
__global__ void __launch_bounds__(kMaxWarps * 32, 4) roi_align_fwd_kernel(
    const Levels lv, const float* __restrict__ rois, const int* __restrict__ batch_idx,
    const int* __restrict__ levels, int num_images, int channels, int pooled_h,
    int pooled_w, int sampling_ratio, int max_grid, int taps, float* __restrict__ out) {
  constexpr int V = Vec<T>::N;
  // the plan: tap counts, then taps and weights, bin rows first, then columns
  extern __shared__ int plan[];
  const int n_bins = pooled_h + pooled_w;
  int* plan_n = plan;
  int* plan_idx = plan + n_bins;
  float* plan_wt = reinterpret_cast<float*>(plan_idx + n_bins * taps);

  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int pw = blockIdx.z * (blockDim.x >> 5) + (threadIdx.x >> 5);  // this warp's column
  const int c0 = (blockIdx.y * kLanes + lane) * V;
  const bool active = c0 < channels && pw < pooled_w;
  const size_t row_out = static_cast<size_t>(pooled_w) * channels;
  float* o = out + static_cast<size_t>(r) * pooled_h * row_out + static_cast<size_t>(pw) * channels + c0;

  const int lvl = levels[r];
  const int b = batch_idx[r];
  if (lvl < 0 || lvl >= lv.count || b < 0 || b >= num_images) {
    // out-of-range indices read nothing and give zeros
    const float zero[V] = {};
    if (active)
      for (int ph = 0; ph < pooled_h; ++ph, o += row_out) store_cs<V>(o, zero, 1.f);
    return;
  }

  const int height = lv.height[lvl];
  const int width = lv.width[lvl];
  const float s = lv.scale[lvl];
  const float4 box = *reinterpret_cast<const float4*>(rois + 4 * static_cast<size_t>(r));
  const float start_w = __fmul_rn(box.x, s);
  const float start_h = __fmul_rn(box.y, s);
  const float roi_w = fmaxf(__fsub_rn(__fmul_rn(box.z, s), start_w), 1.f);
  const float roi_h = fmaxf(__fsub_rn(__fmul_rn(box.w, s), start_h), 1.f);
  const float bin_h = __fdiv_rn(roi_h, static_cast<float>(pooled_h));
  const float bin_w = __fdiv_rn(roi_w, static_cast<float>(pooled_w));
  int grid_h = sampling_ratio;
  int grid_w = sampling_ratio;
  if (sampling_ratio <= 0) {  // adaptive: ceil(roi / pooled) clipped to [1, max_grid]
    grid_h = static_cast<int>(fminf(fmaxf(ceilf(bin_h), 1.f), static_cast<float>(max_grid)));
    grid_w = static_cast<int>(fminf(fmaxf(ceilf(bin_w), 1.f), static_cast<float>(max_grid)));
  }
  const float inv_count = __fdiv_rn(1.f, static_cast<float>(grid_h * grid_w));

  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
    int* idx = plan_idx + j * taps;
    float* wt = plan_wt + j * taps;
    if (j < pooled_h) {
      plan_n[j] = axis_taps(start_h, bin_h, grid_h, j, height, idx, wt);
    } else {
      const int n = axis_taps(start_w, bin_w, grid_w, j - pooled_h, width, idx, wt);
      for (int t = 0; t < n; ++t) idx[t] *= channels;  // columns as element offsets
      plan_n[j] = n;
    }
  }
  __syncthreads();
  if (!active) return;

  const T* feat = static_cast<const T*>(lv.ptr[lvl]) + static_cast<size_t>(b) * lv.img_stride[lvl] + c0;
  const int row_pitch = width * channels;
  const int nc = plan_n[pooled_h + pw];
  const int* plan_col = plan_idx + (pooled_h + pw) * taps;
  const float* plan_wx = plan_wt + (pooled_h + pw) * taps;
  int col[kTaps2];
  float wx[kTaps2];
#pragma unroll
  for (int j = 0; j < kTaps2; ++j) {
    col[j] = kTaps == kTaps2 && j < nc ? plan_col[j] : 0;
    wx[j] = kTaps == kTaps2 && j < nc ? plan_wx[j] : 0.f;
  }
  // the two x-interpolated rows formed last, and their row numbers
  float xa[V], xb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) xa[k] = xb[k] = 0.f;
  int ra = -1, rb = -1;
  for (int ph = 0; ph < pooled_h; ++ph, o += row_out) {
    const int nr = plan_n[ph];
    const int* rows = plan_idx + ph * taps;
    const float* wy = plan_wt + ph * taps;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    // acc += wy * X(y) for the bin row's t-th row y, formed unless it is one
    // of the last two
    auto add_row = [&](int t) {
      const int y = rows[t];
      if (y == rb) {
        fma_row<V>(acc, wy[t], xb);
      } else if (y == ra) {
        fma_row<V>(acc, wy[t], xa);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) xa[k] = xb[k];
        ra = rb;
        interp_row<T, kTaps>(feat + y * row_pitch, nc, col, wx, plan_col, plan_wx, xb);
        rb = y;
        fma_row<V>(acc, wy[t], xb);
      }
    };
    if (kTaps > 0) {
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
        if (t < nr) add_row(t);
    } else {
      for (int t = 0; t < nr; ++t) add_row(t);
    }
    store_cs<V>(o, acc, inv_count);
  }
}

template <typename T, int kTaps>
cudaError_t launch(const Levels& lv, const float* rois, const int* batch_idx, const int* levels,
                   int num_images, int num_rois, int channels, int pooled_h, int pooled_w,
                   int sampling_ratio, int max_grid, int taps, float* out, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  const int slices = (channels / V + kLanes - 1) / kLanes;
  const int groups = (pooled_w + kMaxWarps - 1) / kMaxWarps;
  const int warps = (pooled_w + groups - 1) / groups;  // 7 for both 7x7 and 14x14
  const dim3 grid(static_cast<unsigned>(num_rois), static_cast<unsigned>(slices),
                  static_cast<unsigned>(groups));
  const int threads = 32 * warps;
  const size_t smem = sizeof(int) * static_cast<size_t>(pooled_h + pooled_w) * (1 + 2 * taps);
  roi_align_fwd_kernel<T, kTaps><<<grid, threads, smem, st>>>(
      lv, rois, batch_idx, levels, num_images, channels, pooled_h, pooled_w, sampling_ratio,
      max_grid, taps, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Level tables are host arrays of
// `num_levels` entries; all other pointers are device pointers. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
//   dtype: 0 = float32 features, 1 = bfloat16 features.
extern "C" int roi_align_fwd(int device, int dtype, int num_levels, const void* const* level_ptrs,
                             const long long* level_img_strides, const int* level_heights,
                             const int* level_widths, const float* level_scales, int num_images,
                             const float* rois, const int* batch_idx, const int* levels,
                             int num_rois, int channels, int pooled_h, int pooled_w,
                             int sampling_ratio, int max_grid, float* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || num_rois < 1 || pooled_h < 1 ||
      pooled_w < 1 || channels % 8 != 0 || (dtype != 0 && dtype != 1) ||
      (sampling_ratio <= 0 && max_grid < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // taps per bin and axis: two per sample at most
  const int grid_max = sampling_ratio > 0 ? sampling_ratio : max_grid;
  const int taps = grid_max <= kTaps2 / 2 ? kTaps2 : 2 * grid_max;
  if (sizeof(int) * static_cast<long long>(pooled_h + pooled_w) * (1 + 2 * taps) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Levels lv;
  lv.count = num_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < num_levels;
    lv.ptr[i] = used ? level_ptrs[i] : nullptr;
    lv.img_stride[i] = used ? level_img_strides[i] : 0;
    lv.height[i] = used ? level_heights[i] : 0;
    lv.width[i] = used ? level_widths[i] : 0;
    lv.scale[i] = used ? level_scales[i] : 0.f;
    if (used && static_cast<long long>(level_heights[i]) * level_widths[i] * channels >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);  // offsets within an image are int
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = taps == kTaps2;
  if (dtype == 1)
    err = two ? launch<__nv_bfloat16, kTaps2>(lv, rois, batch_idx, levels, num_images, num_rois,
                                             channels, pooled_h, pooled_w, sampling_ratio,
                                             max_grid, taps, out, st)
              : launch<__nv_bfloat16, 0>(lv, rois, batch_idx, levels, num_images, num_rois,
                                         channels, pooled_h, pooled_w, sampling_ratio, max_grid,
                                         taps, out, st);
  else
    err = two ? launch<float, kTaps2>(lv, rois, batch_idx, levels, num_images, num_rois, channels,
                                      pooled_h, pooled_w, sampling_ratio, max_grid, taps, out, st)
              : launch<float, 0>(lv, rois, batch_idx, levels, num_images, num_rois, channels,
                                 pooled_h, pooled_w, sampling_ratio, max_grid, taps, out, st);
  return static_cast<int>(err);
}
