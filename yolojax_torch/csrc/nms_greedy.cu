// Batched greedy NMS for Hopper (sm_90a).
//
// Replaces yolojax/postprocess/pallas_nms.py::nms_greedy_pallas (kernel body
// _nms_kernel). It computes the same function: candidates arrive sorted by
// descending score and already shifted by class; box i is kept iff it is
// valid and no earlier *kept* box j < i has IoU(i, j) > iou_thresh, with
// IoU = inter / max(union, 1e-10).
//
// What bounds it on this card: neither bytes nor arithmetic. At the serving
// point (N = 128 images, K = 256 candidates) it reads ~0.6 MB and computes
// ~4.2M IoUs (~1 us of f32 work at 67 TFLOP/s); what remains is the greedy
// sweep, K dependent steps per image, so the kernel is latency-bound.
//
// Design against that bound:
//   * one block per image (128 blocks fill the 132 SMs); the image's K
//     boxes and their areas are staged in shared memory;
//   * all warps build a bit-packed "earlier overlap" matrix: row i holds bit
//     j for each j < i with IoU(i, j) > thr, in ceil(K/64) uint64 words
//     (8 KB at K = 256). Each warp computes 32 IoUs of one row at once and
//     packs them with one ballot, so no step of the sweep computes an IoU;
//   * one warp then runs the sweep over the bit matrix: lane w holds word w
//     of the keep mask, and step i is one AND per lane plus one __any_sync.
//     Bits j >= i are never set, so the ragged last word needs no padding
//     and any K <= 1024 runs as is (above 48 KB of shared memory the launch
//     raises the block's dynamic shared memory limit).
//
// Floating point: the IoU repeats the expression order of _nms_kernel and
// yolojax/ops/boxes.py::iou_pairwise with round-to-nearest intrinsics, and
// the file is built with -fmad=false, so nothing is contracted into an FMA
// and the keep mask is bit-identical to the plain PyTorch sweep.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 1024;

__device__ __forceinline__ bool overlaps(int i, int j, const float* y0,
                                         const float* x0, const float* y1,
                                         const float* x1, const float* area,
                                         float iou_thresh) {
  const float ih = fmaxf(__fsub_rn(fminf(y1[i], y1[j]), fmaxf(y0[i], y0[j])), 0.0f);
  const float iw = fmaxf(__fsub_rn(fminf(x1[i], x1[j]), fmaxf(x0[i], x0[j])), 0.0f);
  const float inter = __fmul_rn(ih, iw);
  const float uni = __fsub_rn(__fadd_rn(area[i], area[j]), inter);
  const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-10f));
  return iou > iou_thresh;
}

__global__ void __launch_bounds__(kThreads)
nms_greedy_kernel(const float* __restrict__ boxes,
                  const uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ keep, int k, float iou_thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 63) / 64;
  uint64_t* rows = reinterpret_cast<uint64_t*>(smem);  // [k][words]
  float* y0 = reinterpret_cast<float*>(rows + static_cast<size_t>(k) * words);
  float* x0 = y0 + k;
  float* y1 = x0 + k;
  float* x1 = y1 + k;
  float* area = x1 + k;
  uint8_t* vld = reinterpret_cast<uint8_t*>(area + k);

  const size_t img = blockIdx.x;
  const float* b = boxes + img * k * 4;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float4 bx = reinterpret_cast<const float4*>(b)[i];
    y0[i] = bx.x;
    x0[i] = bx.y;
    y1[i] = bx.z;
    x1[i] = bx.w;
    area[i] = __fmul_rn(fmaxf(__fsub_rn(bx.z, bx.x), 0.0f),
                        fmaxf(__fsub_rn(bx.w, bx.y), 0.0f));
    vld[i] = valid[img * k + i];
  }
  __syncthreads();

  // Overlap rows: task (i, h) fills 32-bit half h of row i with one ballot.
  // The task index is the same on every lane of a warp, so each branch
  // below is taken by the whole warp and the ballot sees all 32 lanes.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int halves = 2 * words;
  uint32_t* rows32 = reinterpret_cast<uint32_t*>(rows);
  for (int t = warp; t < k * halves; t += kThreads / 32) {
    const int i = t / halves;
    const int j0 = (t - i * halves) * 32;
    if (j0 >= i) {  // no j < i in this half: nothing to compute
      if (lane == 0) rows32[t] = 0u;
      continue;
    }
    const int j = j0 + lane;
    const bool ov = j < i && overlaps(i, j, y0, x0, y1, x1, area, iou_thresh);
    const uint32_t bits = __ballot_sync(0xffffffffu, ov);
    if (lane == 0) rows32[t] = bits;  // little-endian: half 2w is the low word
  }
  __syncthreads();

  // Greedy sweep: one warp, lane w owns word w of the keep bits.
  if (warp == 0) {
    uint64_t kept = 0;
    uint8_t* out = keep + img * k;
    for (int i = 0; i < k; ++i) {
      const bool hit = lane < words && (rows[static_cast<size_t>(i) * words + lane] & kept) != 0;
      const bool suppressed = __any_sync(0xffffffffu, hit);
      const bool kp = vld[i] != 0 && !suppressed;
      if (kp && lane == (i >> 6)) kept |= 1ull << (i & 63);
      if (lane == 0) out[i] = kp;
    }
  }
}

size_t smem_bytes(int k) {
  const size_t words = (k + 63) / 64;
  return static_cast<size_t>(k) * words * 8 + static_cast<size_t>(k) * (5 * 4 + 1);
}

}  // namespace

extern "C" int nms_greedy_launch(const float* boxes, const uint8_t* valid,
                                 uint8_t* keep, int n, int k, float iou_thresh,
                                 cudaStream_t stream) {
  if (n <= 0 || k <= 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_greedy_kernel<<<n, kThreads, smem, stream>>>(boxes, valid, keep, k, iou_thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nms_greedy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
