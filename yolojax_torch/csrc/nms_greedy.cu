// Batched greedy NMS for Hopper (sm_90a).
//
// Replaces yolojax/postprocess/pallas_nms.py::nms_greedy_pallas (kernel body
// _nms_kernel). It computes the same function: candidates arrive sorted by
// descending score and already shifted by class; box i is kept iff it is
// valid and no earlier *kept* box j < i has IoU(i, j) > iou_thresh, with
// IoU = inter / max(union, 1e-10).
//
// What bounds it on this card: neither bytes nor arithmetic. At the serving
// point (N = 128 images, K = 256 candidates) it reads ~0.6 MB and the IoUs
// this data needs take ~0.8 us at the f32 peak; what remains is latency:
// the greedy sweep is a chain of K dependent decisions an image. Timed
// apart on the card, the earlier one-block-an-image kernel spent 52 of its
// 69 us in the IoU build, which ran on 16 warps an SM, and 17 us in the
// sweep (PERF.md). So this version spreads the build and shortens the
// chain:
//
//   * build kernel: one 256-thread block for each (image, band of 16 rows),
//     2,048 blocks at N = 128, K = 256, so every SM has its warp slots full.
//     It computes only the lower triangle (j < i) and writes row i's bits
//     for words w <= i / 64 into an (N, K, ceil(K/64)) uint64 scratch that
//     the wrapper allocates (1 MB at the serving point, so it stays in L2).
//     Each warp packs 64 IoU tests of one row into one word with two
//     ballots. A pair that does not intersect has IoU exactly 0 and skips
//     the division, which most pairs of different classes never need;
//   * sweep kernel: one warp an image walks the 64-row word blocks. For
//     block w, lanes first mark, in parallel, the rows suppressed by a box
//     kept in an earlier block (an AND with that block's kept word and an
//     OR over the words < w), and vote the block's candidates. Then the 64
//     in-block dependences resolve in two 32-step chains over the diagonal
//     words, which every lane holds in registers: each step is an AND, a
//     compare and an OR, with no memory access and no vote. Rows 32..63 are
//     first cleared, in parallel, of the kept rows 0..31. The keep bytes
//     are written once a block.
//
// Floating point: the IoU repeats the expression order of _nms_kernel and
// yolojax/ops/boxes.py::iou_pairwise with round-to-nearest intrinsics,
// including the division, and the file is built with -fmad=false, so
// nothing is contracted into an FMA and the keep mask is bit-identical to
// the plain PyTorch sweep. K up to 1024 runs unpadded: bits j >= i are
// never set and rows past K are never candidates.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;
constexpr int kMaxWords = kMaxK / 64;
constexpr int kBuildThreads = 256;
constexpr int kBandRows = 16;  // overlap rows a build block computes


__device__ __forceinline__ bool overlaps(const float4 bi, float ai, const float4 bj,
                                         float aj, float iou_thresh) {
  // box = (y0, x0, y1, x1)
  const float ih = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.0f);
  const float iw = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.0f);
  const float inter = __fmul_rn(ih, iw);
  const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
  // 0 / max(union, 1e-10) is exactly 0: no division there
  const float iou = inter == 0.0f ? 0.0f : __fdiv_rn(inter, fmaxf(uni, 1e-10f));
  return iou > iou_thresh;
}

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__global__ void __launch_bounds__(kBuildThreads)
nms_build_kernel(const float4* __restrict__ boxes, uint64_t* __restrict__ bits, int k,
                 int words, int bands, float iou_thresh) {
  __shared__ float4 sb[kMaxK];
  __shared__ float sa[kMaxK];
  const int img = blockIdx.x / bands;
  const int i0 = (blockIdx.x - img * bands) * kBandRows;
  const int jn = min(i0 + kBandRows, k);  // rows [i0, jn) need boxes j < jn
  const float4* b = boxes + static_cast<size_t>(img) * k;
  for (int j = threadIdx.x; j < jn; j += kBuildThreads) {
    const float4 bx = b[j];
    sb[j] = bx;
    sa[j] = box_area(bx);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = i0 + warp; i < jn; i += kBuildThreads / 32) {
    const float4 bi = sb[i];
    const float ai = sa[i];
    uint64_t* row = bits + (static_cast<size_t>(img) * k + i) * words;
    for (int w = 0; w <= i / 64; ++w) {  // the same bound on every lane
      const int j0 = 64 * w + lane;
      const int j1 = j0 + 32;
      const bool ov0 = j0 < i && overlaps(bi, ai, sb[j0], sa[j0], iou_thresh);
      const bool ov1 = j1 < i && overlaps(bi, ai, sb[j1], sa[j1], iou_thresh);
      const uint32_t lo = __ballot_sync(0xffffffffu, ov0);
      const uint32_t hi = __ballot_sync(0xffffffffu, ov1);
      if (lane == 0) row[w] = static_cast<uint64_t>(hi) << 32 | lo;
    }
  }
}

// One warp an image. Lane l owns rows 64w + l ("a") and 64w + 32 + l ("b")
// of word block w.
__global__ void __launch_bounds__(32)
nms_sweep_kernel(const uint64_t* __restrict__ bits, const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep, int k, int words) {
  __shared__ uint64_t kept_words[kMaxWords];
  const int lane = threadIdx.x;
  const size_t img = blockIdx.x;
  const uint64_t* ib = bits + img * k * words;
  const uint8_t* iv = valid + img * k;
  uint8_t* out = keep + img * k;

  for (int w = 0; w < words; ++w) {
    const int ra = 64 * w + lane;
    const int rb = ra + 32;
    const bool in_a = ra < k, in_b = rb < k;
    // this block's diagonal words, and suppression by earlier blocks' kept boxes
    const uint64_t da = in_a ? ib[static_cast<size_t>(ra) * words + w] : 0;
    const uint64_t db = in_b ? ib[static_cast<size_t>(rb) * words + w] : 0;
    uint64_t hit_a = 0, hit_b = 0;
    for (int v = 0; v < w; ++v) {
      const uint64_t kv = kept_words[v];
      if (in_a) hit_a |= ib[static_cast<size_t>(ra) * words + v] & kv;
      if (in_b) hit_b |= ib[static_cast<size_t>(rb) * words + v] & kv;
    }
    const uint32_t cand_a =
        __ballot_sync(0xffffffffu, in_a && iv[ra] != 0 && hit_a == 0);
    uint32_t cand_b = __ballot_sync(0xffffffffu, in_b && iv[rb] != 0 && hit_b == 0);

    // rows 0..31 of the block: their bits j < i all lie in the low half
    uint32_t dlo[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dlo[i] = __shfl_sync(0xffffffffu, static_cast<uint32_t>(da), i);
    uint32_t kept_a = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      kept_a |= (dlo[i] & kept_a) == 0 ? cand_a & (1u << i) : 0u;

    // rows 32..63: first the kept rows 0..31 (one parallel test), then the chain
    cand_b &= ~__ballot_sync(0xffffffffu, (static_cast<uint32_t>(db) & kept_a) != 0);
    uint32_t dhi[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dhi[i] = __shfl_sync(0xffffffffu, static_cast<uint32_t>(db >> 32), i);
    uint32_t kept_b = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      kept_b |= (dhi[i] & kept_b) == 0 ? cand_b & (1u << i) : 0u;

    if (lane == 0) kept_words[w] = static_cast<uint64_t>(kept_b) << 32 | kept_a;
    if (in_a) out[ra] = (kept_a >> lane) & 1u;
    if (in_b) out[rb] = (kept_b >> lane) & 1u;
    __syncwarp();
  }
}

}  // namespace

// The build (boxes -> bits), then the sweep (bits, valid -> keep), on one
// stream. bits is (n, k, ceil(k/64)) uint64 scratch.
extern "C" int nms_greedy_launch(const float* boxes, const uint8_t* valid,
                                 uint8_t* keep, uint64_t* bits, int n, int k,
                                 float iou_thresh, cudaStream_t stream) {
  if (n <= 0 || k <= 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (k + 63) / 64;
  const int bands = (k + kBandRows - 1) / kBandRows;
  if (static_cast<long long>(n) * bands > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  nms_build_kernel<<<n * bands, kBuildThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(boxes), bits, k, words, bands, iou_thresh);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<n, 32, 0, stream>>>(bits, valid, keep, k, words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nms_greedy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
