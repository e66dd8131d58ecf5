// Multilevel FPN RoIAlign forward for Hopper (sm_90a), caffe2 semantics.
//
// Replaces the Pallas TPU kernel `_roi_align_pallas_batched`
// (detectorch_tpu/ops/pallas/roi_align_kernel.py:164, pallas_call at :346).
// That kernel DMAs a 64x64 window of a padded, image-major level atlas into
// VMEM per roi and contracts it with two hat-weight matrices on the MXU; rois
// whose sampling footprint overflows the window come back flagged for an exact
// rerun. None of that carries over: here each roi's geometry is computed in
// the kernel with the rules of detectorch_tpu/ops/roi_align.py:44-76 and
// :379-412, and the four bilinear taps of every sample are read straight from
// the NHWC features. The result is exact for every roi.
//
// What bounds it: it is a gather. At 7x7 with 2x2 samples per bin a roi
// reads 49 * 4 * 4 taps of C = 256 channels (about 400 KB in bf16, mostly
// hits in L1/L2, since neighbouring samples share taps) and writes
// 49 * 256 * 4 B = 50 KB of fp32; the box call at batch 8 (8000 rois) writes
// about 400 MB. The design keeps every load 16 bytes wide and channel-
// contiguous (a warp reads 512 contiguous bytes per tap), accumulates in fp32
// registers, and writes each output element exactly once.
//
// Layout: one block per (roi, ph) output row; threads stride over
// (pw, channel vector). Features are bf16 or fp32 NHWC: a channels_last NCHW
// tensor permuted to NHWC already is. Output (R, PH, PW, C) fp32.
//
// The geometry uses the _rn intrinsics so nvcc cannot contract it into FMAs:
// sample coordinates then round exactly as the plain PyTorch version's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;

struct Levels {
  const void* ptr[kMaxLevels];
  long long img_stride[kMaxLevels];  // elements between consecutive images
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
  int count;
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// Sample coordinate start + p*bin + (i+0.5)*bin/grid, rounded step by step.
__device__ __forceinline__ float sample_coord(float start, int p, float bin, int i, int grid) {
  return __fadd_rn(__fadd_rn(start, __fmul_rn(static_cast<float>(p), bin)),
                   __fdiv_rn(__fmul_rn(static_cast<float>(i) + 0.5f, bin),
                             static_cast<float>(grid)));
}

template <typename T>
__global__ void __launch_bounds__(1024) roi_align_fwd_kernel(
    const Levels lv, const float* __restrict__ rois, const int* __restrict__ batch_idx,
    const int* __restrict__ levels, int num_images, int channels, int pooled_h,
    int pooled_w, int sampling_ratio, int max_grid, float* __restrict__ out) {
  constexpr int V = Vec<T>::N;
  const int r = blockIdx.x / pooled_h;
  const int ph = blockIdx.x - r * pooled_h;
  const int cvecs = channels / V;
  const int items = pooled_w * cvecs;
  float* out_row = out + (static_cast<size_t>(r) * pooled_h + ph) * pooled_w * channels;

  const int lvl = levels[r];
  const int b = batch_idx[r];
  if (lvl < 0 || lvl >= lv.count || b < 0 || b >= num_images) {
    // out-of-range indices read nothing and give zeros
    for (int t = threadIdx.x; t < items; t += blockDim.x) {
      float* o = out_row + t * V;
#pragma unroll
      for (int k = 0; k < V; k += 4) *reinterpret_cast<float4*>(o + k) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  const int height = lv.height[lvl];
  const int width = lv.width[lvl];
  const float s = lv.scale[lvl];
  const T* feat = static_cast<const T*>(lv.ptr[lvl]) + static_cast<size_t>(b) * lv.img_stride[lvl];

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
  const float fh = static_cast<float>(height);
  const float fw = static_cast<float>(width);
  const size_t row_pitch = static_cast<size_t>(width) * channels;

  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int pw = t / cvecs;
    const int c0 = (t - pw * cvecs) * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;

    for (int iy = 0; iy < grid_h; ++iy) {
      float y = sample_coord(start_h, ph, bin_h, iy, grid_h);
      if (y < -1.f || y > fh) continue;  // zero, but still counted
      y = fminf(fmaxf(y, 0.f), fh - 1.f);
      const int y0 = static_cast<int>(floorf(y));
      const int y1 = min(y0 + 1, height - 1);
      const float ly = __fsub_rn(y, static_cast<float>(y0));
      const float hy = __fsub_rn(1.f, ly);
      const T* row0 = feat + y0 * row_pitch + c0;
      const T* row1 = feat + y1 * row_pitch + c0;
      for (int ix = 0; ix < grid_w; ++ix) {
        float x = sample_coord(start_w, pw, bin_w, ix, grid_w);
        if (x < -1.f || x > fw) continue;
        x = fminf(fmaxf(x, 0.f), fw - 1.f);
        const int x0 = static_cast<int>(floorf(x));
        const int x1 = min(x0 + 1, width - 1);
        const float lx = __fsub_rn(x, static_cast<float>(x0));
        const float hx = __fsub_rn(1.f, lx);
        const float w00 = __fmul_rn(hy, hx), w01 = __fmul_rn(hy, lx);
        const float w10 = __fmul_rn(ly, hx), w11 = __fmul_rn(ly, lx);
        float v00[V], v01[V], v10[V], v11[V];
        Vec<T>::load(row0 + static_cast<size_t>(x0) * channels, v00);
        Vec<T>::load(row0 + static_cast<size_t>(x1) * channels, v01);
        Vec<T>::load(row1 + static_cast<size_t>(x0) * channels, v10);
        Vec<T>::load(row1 + static_cast<size_t>(x1) * channels, v11);
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[k] += w00 * v00[k] + w01 * v01[k] + w10 * v10[k] + w11 * v11[k];
      }
    }
    float* o = out_row + static_cast<size_t>(pw) * channels + c0;
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(o + k) =
          make_float4(acc[k] * inv_count, acc[k + 1] * inv_count, acc[k + 2] * inv_count,
                      acc[k + 3] * inv_count);
  }
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
      pooled_w < 1 || channels % 8 != 0 || (dtype != 0 && dtype != 1))
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
  }
  const int vec = dtype == 1 ? Vec<__nv_bfloat16>::N : Vec<float>::N;
  const int items = pooled_w * (channels / vec);
  const int threads = items >= 1024 ? 1024 : (items + 31) / 32 * 32;
  const dim3 grid(static_cast<unsigned>(num_rois) * static_cast<unsigned>(pooled_h));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        lv, rois, batch_idx, levels, num_images, channels, pooled_h, pooled_w, sampling_ratio,
        max_grid, out);
  else
    roi_align_fwd_kernel<float><<<grid, threads, 0, st>>>(lv, rois, batch_idx, levels,
                                                          num_images, channels, pooled_h,
                                                          pooled_w, sampling_ratio, max_grid, out);
  return static_cast<int>(cudaGetLastError());
}
