// Batched greedy NMS for Hopper (sm_90a), Detectron semantics.
//
// Replaces no Pallas kernel: JAX's `nms_blocked` (detectorch_tpu/ops/nms.py)
// is plain jnp, and the port ran it as PyTorch operators
// (ops/nms.batched_nms_blocked). On the card that form paid twice: a host
// sync per fixpoint iteration of every 128-box block (torch.equal drains the
// stream; ~2 a block), and ~15 elementwise passes over (rows, 128, N) fp32
// tensors per block for the IoU. This kernel takes both away: the IoU is
// computed once per pair into a bitmask, the greedy order is resolved on the
// device, and the host never waits.
//
// Input (from ops/nms.sort_rows): per row the boxes sorted by descending
// score, ties to the higher input index, `alive` (valid and scored) and the
// permutation `order` back to input indices. Output: per row the input
// indices of the first max_out kept boxes in score order, and their
// validity; unfilled slots hold 0 and false, as the blocked path leaves them.
//
// Stage 1, detectorch_nms_mask_kernel: grid (column block, row block, row),
// 64 threads. Thread t owns box i of the row block and writes one 64-bit
// word of the (rows, n, ceil(n/64)) mask: bit b of word c is set iff box
// j = 64c + b comes after i and IoU(i, j) >= thresh. Only the upper
// triangle is written (column block >= row block), and only for live boxes;
// the scan reads nothing else. The IoU follows ops/boxes.bbox_overlaps in
// fp32 step by step: +1 widths and heights, the areas' product, the
// clamped intersection, (area_i + area_j) - inter, and inter / union where
// union > 0, else 0. The _rn intrinsics keep nvcc from contracting any of
// it into an FMA, and the division is IEEE, so each bit decides as the
// PyTorch comparison with fp32(thresh) does. (fminf/fmaxf differ from
// torch.minimum only on NaN, where the box's area, and so the union, is NaN
// and both sides read 0; a zero intersection reads 0 without the division.)
//
// Stage 2, detectorch_nms_scan_kernel: one CTA per row. `removed` holds one
// bit per box in shared memory. The row is walked in 64-box chunks: warp 0
// loads the chunk's diagonal words and its live bits, and resolves the
// chunk's greedy order bit by bit (the lowest candidate is kept, its word
// clears the later candidates it overlaps), writing each kept box straight
// into its output slot; then every thread ORs the kept boxes' words into
// the later chunks' `removed` words. Dead boxes are never kept, so they
// never suppress. The walk stops once max_out boxes are kept: the output is
// the first max_out kept positions, so the rest of the row cannot change
// it. No atomics: the result is deterministic.
//
// What bounds it on the H100: stage 1 is the IoU arithmetic (n^2/2 pairs a
// row, ~20 fp32 operations each, the division only where boxes meet) and
// the mask's writes (n^2/16 bytes a row); stage 2 is latency: one chunk at
// a time, a dependent chain of warp shuffles inside it and two barriers
// between chunks, on one SM per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 64;          // boxes per mask word, per stage-1 block and per scan chunk
constexpr int kScanThreads = 128;  // stage 2: warp 0 resolves, all OR

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.f), __fadd_rn(__fsub_rn(b.w, b.y), 1.f));
}

// ops/boxes.bbox_overlaps(a, b) >= thresh, in its fp32 order
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b,
                                         float thresh) {
  float iw = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f);
  float ih = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f);
  iw = iw < 0.f ? 0.f : iw;  // clamp_min(0), NaN kept
  ih = ih < 0.f ? 0.f : ih;
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = (uni > 0.f && inter > 0.f) ? __fdiv_rn(inter, uni) : 0.f;
  return iou >= thresh;
}

__global__ void __launch_bounds__(kWord) detectorch_nms_mask_kernel(
    const float4* __restrict__ boxes, const uint8_t* __restrict__ alive, int n, int words,
    float thresh, unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x, row_block = blockIdx.y;
  if (col_block < row_block) return;  // the lower triangle is never read
  const size_t row0 = static_cast<size_t>(blockIdx.z) * n;
  const int t = threadIdx.x;
  __shared__ float4 cols[kWord];
  __shared__ float col_area[kWord];
  const int j = col_block * kWord + t;
  const float4 cb = j < n ? boxes[row0 + j] : make_float4(0.f, 0.f, 0.f, 0.f);
  cols[t] = cb;
  col_area[t] = box_area(cb);
  const int i = row_block * kWord + t;
  const bool live = i < n && alive[row0 + i];
  if (!__syncthreads_or(live) || !live) return;
  const float4 b = boxes[row0 + i];
  const float area = box_area(b);
  const int first = col_block == row_block ? t + 1 : 0;
  const int last = min(kWord, n - col_block * kWord);
  unsigned long long word = 0;
  for (int k = first; k < last; ++k)
    if (overlaps(b, area, cols[k], col_area[k], thresh)) word |= 1ull << k;
  mask[(row0 + i) * words + col_block] = word;
}

__global__ void __launch_bounds__(kScanThreads) detectorch_nms_scan_kernel(
    const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ alive,
    const long long* __restrict__ order, int n, int words, int max_out,
    long long* __restrict__ keep_idx, bool* __restrict__ keep_valid) {
  extern __shared__ unsigned long long removed[];  // one word per chunk
  __shared__ int kept_bits[kWord];                 // the chunk's kept boxes, in order
  __shared__ int kept_count;
  const int t = threadIdx.x, lane = t & 31;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * n;
  long long* out_idx = keep_idx + static_cast<size_t>(blockIdx.x) * max_out;
  bool* out_ok = keep_valid + static_cast<size_t>(blockIdx.x) * max_out;
  for (int w = t; w < words; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();
  int filled = 0;  // the same in every thread
  for (int c = 0; c < words && filled < max_out; ++c) {
    const int base = c * kWord;
    if (t < 32) {
      const int i0 = base + lane, i1 = base + 32 + lane;
      const bool a0 = i0 < n && alive[row0 + i0];
      const bool a1 = i1 < n && alive[row0 + i1];
      const unsigned long long d0 = a0 ? mask[(row0 + i0) * words + c] : 0ull;
      const unsigned long long d1 = a1 ? mask[(row0 + i1) * words + c] : 0ull;
      unsigned long long remaining =
          ((static_cast<unsigned long long>(__ballot_sync(0xffffffffu, a1)) << 32) |
           __ballot_sync(0xffffffffu, a0)) & ~removed[c];
      int kept = 0;
      while (remaining && filled + kept < max_out) {  // uniform across the warp
        const int b = __ffsll(static_cast<long long>(remaining)) - 1;
        const unsigned long long row = __shfl_sync(0xffffffffu, b < 32 ? d0 : d1, b & 31);
        if (lane == 0) {
          out_idx[filled + kept] = order[row0 + base + b];
          out_ok[filled + kept] = true;
          kept_bits[kept] = b;
        }
        ++kept;
        remaining &= remaining - 1;  // b itself
        remaining &= ~row;           // the later boxes of the chunk that b overlaps
      }
      if (lane == 0) kept_count = kept;
    }
    __syncthreads();
    const int kept = kept_count;
    filled += kept;
    if (kept && filled < max_out) {
      for (int w = c + 1 + t; w < words; w += blockDim.x) {
        unsigned long long acc = 0ull;
#pragma unroll 4
        for (int k = 0; k < kept; ++k) acc |= mask[(row0 + base + kept_bits[k]) * words + w];
        removed[w] |= acc;
      }
    }
    __syncthreads();
  }
  for (int s = filled + t; s < max_out; s += blockDim.x) {
    out_idx[s] = 0;
    out_ok[s] = false;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes; every pointer is a device pointer.
// boxes (rows, n, 4) fp32 sorted by score, alive (rows, n) bool, order
// (rows, n) int64; mask (rows, n, words) 64-bit scratch, words = ceil(n/64);
// keep_idx (rows, max_out) int64 and keep_valid (rows, max_out) bool, every
// slot written. The scan's `removed` words (8 bytes each) must fit the
// dynamic shared memory its launch may take: 48 KB less its static arrays,
// as cudaFuncGetAttributes reports. Launches both stages on `stream`, checks cudaGetLastError()
// after each and returns it (0 on success).
extern "C" int detectorch_nms(int device, const void* boxes, const void* alive, const void* order,
                              int rows, int n, int words, float thresh, int max_out, void* mask,
                              void* keep_idx, void* keep_valid, void* stream) {
  if (rows < 1 || rows > 65535 || n < 1 || words != (n + kWord - 1) / kWord || words > 65535 ||
      max_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes scan;
  err = cudaFuncGetAttributes(&scan, detectorch_nms_scan_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sizeof(unsigned long long) * static_cast<size_t>(words) >
      static_cast<size_t>(scan.maxDynamicSharedSizeBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(words), static_cast<unsigned>(words),
                  static_cast<unsigned>(rows));
  detectorch_nms_mask_kernel<<<grid, kWord, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(alive), n, words, thresh,
      static_cast<unsigned long long*>(mask));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  detectorch_nms_scan_kernel<<<rows, kScanThreads, sizeof(unsigned long long) * words, st>>>(
      static_cast<const unsigned long long*>(mask), static_cast<const uint8_t*>(alive),
      static_cast<const long long*>(order), n, words, max_out,
      static_cast<long long*>(keep_idx), static_cast<bool*>(keep_valid));
  return static_cast<int>(cudaGetLastError());
}
