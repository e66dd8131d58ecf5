// The trunk's frozen-BN conv epilogue for Hopper (sm_90a): the BN scale folded
// into the conv's weight, and bias + residual + relu as one pass over the
// conv's output.
//
// Replaces no Pallas kernel: the JAX package's trunk
// (detectorch_tpu/models/resnet.py) writes the frozen-BN affine, the residual
// add and the relu in jnp and leaves their fusion to XLA. The port ran them
// as PyTorch operators on the conv's channels_last output: a cast of the
// weight, of s and of b, the broadcast multiply and the broadcast add (two
// unvectorised elementwise passes), the relu and, on a block's last conv, the
// residual add. Each pass reads and writes the whole output, and the two
// broadcast passes moved it at ~40% of the card's bandwidth.
//
// detectorch_fold_scale_kernel: out[o, k] = T(W[o, k] * s[o]), the product in
// fp32 rounded once to the conv's type: conv(x, W) * s + b == conv(x, W * s)
// + b (checkpoint/caffe2_import.fold_bn's identity, per call). It takes the
// place of the weight's cast to the activations' type, which the conv needed
// anyway. It walks the weight's memory, OIHW or channels_last: the output
// axis is outermost in both, so s[o] is s[i / (elements per o)].
//
// detectorch_conv_epilogue_kernel: y <- act((y + b[c]) (+ r)), in place, on the
// conv's output seen as (P, C) rows (channels_last memory), C a multiple of 8
// and at most kMaxChannels; b fp32, r of y's type and layout, act relu or
// none. The sum is fp32, rounded once to y's type (to nearest even), so the
// projection block's two biases (b2c + b1, summed in fp32 by the caller) and
// the residual cost no rounding of their own.
//
// What bounds it on the H100: bytes. The epilogue does 1-3 flops an element
// and moves 4 bytes an element in bf16 (y read and written), 6 with the
// residual; at 3.35 TB/s that is the whole of its least time. The design:
//   * 16-byte accesses (8 bf16 or 4 fp32: one channel group of one pixel a
//     thread), neighbouring threads on neighbouring addresses, so that a
//     warp's request is 512 contiguous bytes;
//   * a grid-stride loop over (blocks an SM holds at once) x (132 SMs), so
//     every block is resident, each SM keeps tens of KB of loads in flight,
//     and the few-per-block costs below are paid once per resident block;
//   * the bias (C x 4 bytes, at most 8 KB) copied into shared memory once per
//     block; each step reads its channel group's values from there, and the
//     group index walks with the stride (an add and a compare, no division
//     in the loop), so device memory sees the bias once per block;
//   * y is read and written by the same thread in one step: no second pass,
//     nothing staged through memory.
// The fold moves 6 bytes a weight element in bf16 (fp32 read, bf16 written);
// the trunk's weights are a few hundred MB a request at most.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 2048;  // the bias table: 8 KB of fp32
constexpr int kMaxDevices = 64;

// 16 bytes of T <-> fp32 lanes
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(uint4 q, float (&v)[N]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the top half of the fp32 of the same value; element 2i is the
  // low half of word i
  __device__ __forceinline__ static void unpack(uint4 q, float (&v)[N]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x is the low half
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[N]) {
    return make_uint4(pair(v[0], v[1]), pair(v[2], v[3]), pair(v[4], v[5]), pair(v[6], v[7]));
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool kResidual, bool kRelu>
__global__ void __launch_bounds__(kThreads) detectorch_conv_epilogue_kernel(
    uint4* __restrict__ y, const uint4* __restrict__ r, const float* __restrict__ bias,
    long long vectors, int channels) {
  constexpr int N = Pack<T>::N;
  __shared__ __align__(16) float table[kMaxChannels];
  for (int c = threadIdx.x; c < channels; c += kThreads) table[c] = bias[c];
  __syncthreads();
  const int groups = channels / N;  // 16-byte vectors a pixel
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int step = static_cast<int>(stride % groups);
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int g = static_cast<int>(i % groups);
  for (; i < vectors; i += stride) {
    float v[N];
    Pack<T>::unpack(y[i], v);
    float res[N];
    if (kResidual) Pack<T>::unpack(r[i], res);
    const float4* b = reinterpret_cast<const float4*>(table + g * N);
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 q = b[k];
      v[4 * k] = __fadd_rn(v[4 * k], q.x);
      v[4 * k + 1] = __fadd_rn(v[4 * k + 1], q.y);
      v[4 * k + 2] = __fadd_rn(v[4 * k + 2], q.z);
      v[4 * k + 3] = __fadd_rn(v[4 * k + 3], q.w);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (kResidual) v[k] = __fadd_rn(v[k], res[k]);
      if (kRelu) v[k] = v[k] < 0.f ? 0.f : v[k];  // NaN kept, as torch.relu keeps it
    }
    y[i] = Pack<T>::pack(v);
    g += step;
    if (g >= groups) g -= groups;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) detectorch_fold_scale_kernel(
    const float* __restrict__ w, const float* __restrict__ scale, T* __restrict__ out,
    int per_row, int total) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads)
    out[i] = from_float<T>(__fmul_rn(w[i], scale[i / per_row]));
}

// SMs of `device`, read once
int sm_count(int device) {
  static int sms[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 0;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms[device] = 0;
  return sms[device];
}

// Blocks of `kernel` resident at once on the card: SMs x blocks an SM holds.
template <typename K>
cudaError_t resident_blocks(K kernel, int device, long long* blocks) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(device);
  if (sms < 1 || per_sm < 1) return cudaErrorInvalidValue;
  *blocks = static_cast<long long>(sms) * per_sm;
  return cudaSuccess;
}

template <typename T, bool kResidual, bool kRelu>
cudaError_t launch_epilogue(int device, void* y, const void* r, const float* bias,
                            long long vectors, int channels, cudaStream_t stream) {
  const auto kernel = detectorch_conv_epilogue_kernel<T, kResidual, kRelu>;
  static long long resident = 0;  // per instantiation; the same on every H100
  if (resident == 0) {
    const cudaError_t err = resident_blocks(kernel, device, &resident);
    if (err != cudaSuccess) return err;
  }
  const long long needed = (vectors + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(needed < resident ? needed : resident);
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<uint4*>(y), static_cast<const uint4*>(r),
                                          bias, vectors, channels);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_epilogue(int device, void* y, const void* r, const float* bias,
                            long long vectors, int channels, int relu, cudaStream_t stream) {
  if (r != nullptr)
    return relu ? launch_epilogue<T, true, true>(device, y, r, bias, vectors, channels, stream)
                : launch_epilogue<T, true, false>(device, y, r, bias, vectors, channels, stream);
  return relu ? launch_epilogue<T, false, true>(device, y, r, bias, vectors, channels, stream)
              : launch_epilogue<T, false, false>(device, y, r, bias, vectors, channels, stream);
}

template <typename T>
cudaError_t launch_fold(int device, const float* w, const float* scale, void* out, int per_row,
                        int total, cudaStream_t stream) {
  const auto kernel = detectorch_fold_scale_kernel<T>;
  static long long resident = 0;
  if (resident == 0) {
    const cudaError_t err = resident_blocks(kernel, device, &resident);
    if (err != cudaSuccess) return err;
  }
  const long long needed = (static_cast<long long>(total) + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(needed < resident ? needed : resident);
  kernel<<<blocks, kThreads, 0, stream>>>(w, scale, static_cast<T*>(out), per_row, total);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes; every pointer is a device pointer.
// dtype: 0 = float32, 1 = bfloat16.
//
// detectorch_conv_epilogue: y (elements of y's type, channels_last, the last
// axis `channels`, 16-byte aligned) <- act((y + bias[c]) (+ r)); r null or
// like y; bias `channels` fp32; relu 0 or 1. Launches one kernel on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int detectorch_conv_epilogue(int device, void* y, const void* r, const void* bias,
                                        long long elements, int channels, int dtype, int relu,
                                        void* stream) {
  const int lanes = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || channels < 8 || channels % 8 != 0 ||
      channels > kMaxChannels || elements < 1 || elements % channels != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vectors = elements / lanes;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? launch_epilogue<__nv_bfloat16>(device, y, r, b, vectors, channels, relu, st)
                 : launch_epilogue<float>(device, y, r, b, vectors, channels, relu, st));
}

// detectorch_fold_scale: out (rows x per_row of the output type, w's layout)
// <- w (fp32) * scale[row] (fp32), rounded once. rows * per_row < 2^31.
extern "C" int detectorch_fold_scale(int device, const void* w, const void* scale, void* out,
                                     int rows, int per_row, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || rows < 1 || per_row < 1 ||
      static_cast<long long>(rows) * per_row >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(scale);
  const int total = rows * per_row;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? launch_fold<__nv_bfloat16>(device, wf, sf, out, per_row, total, st)
                 : launch_fold<float>(device, wf, sf, out, per_row, total, st));
}
