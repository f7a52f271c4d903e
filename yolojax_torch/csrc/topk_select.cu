// Exact top-K select for Hopper (sm_90a).
//
// Replaces no Pallas kernel: yolojax selects its candidates with lax.top_k,
// and the port first did so with torch.sort(scores, descending, stable) over
// every score of an image before keeping the first K. This kernel family
// returns exactly that sort's first K columns of each row: the K largest
// scores f32 and their indices int64, ties in ascending index order (the
// order of lax.top_k), -0.0 tied with +0.0, NaN above +inf.
//
// What bounds it on this card: bytes. At YOLOv3-608's serving point (128
// images of 1,819,440 scores, K = 256) the select must read 0.93 GB of f32
// scores once, 0.28 ms at 3.35 TB/s; the arithmetic an element is a few
// integer operations. The full sort it replaces moved each (score, index)
// pair through cub's onesweep passes, ~17 ms. So the design reads each
// score from device memory once and does the rest in shared memory:
//
//   * one 32-bit key a score, ordered as the sort orders the floats (see
//     score_key), so the select works on unsigned integers;
//   * a row is cut into slices of at most kMaxSlice scores, one CTA a slice.
//     The CTA copies its whole slice into shared memory at once with 16-byte
//     asynchronous copies (cp.async: the bytes are in flight together, and
//     no register holds them), turns the scores into keys in place, and
//     keeps the largest key of each thread's share (its load group);
//   * the CTA finds its slice's K-th largest key T by radix select: integer
//     histograms in shared memory of the keys' top 11 bits, then of the next
//     11 and the last 10 within the chosen bucket. No sort, and only integer
//     counts, so the result does not depend on the order of the atomics.
//     Before the first digit, the K-th largest of the load groups' maxima,
//     cut to its top 22 bits (two digits of the same select over 512
//     values), is a floor: K groups hold a key at least that large, so T is
//     not below it, and keys under it are never counted. Scores leave only
//     a few hundred keys of a slice (~1.5%) above that floor. The first
//     digit's pass marks them in a 64-bit mask a thread, over the thread's
//     contiguous range of the slice, and everything after reads only the
//     marked keys: timed by phase on the card, the kernel was bound by the
//     instructions it spends on each key in shared memory (three digit
//     passes and two survivor passes over the slice took ~80% of a CTA's
//     time), so one pass over the slice after the load is what it affords;
//   * the CTA keeps every key above T and, of the keys equal to T, those with
//     the smallest indices until it has min(K, slice) keys. A prefix sum over
//     the threads' ranges, in index order, decides which: the survivors are
//     written in index order;
//   * a slice's survivors are a superset of what the row keeps from it (the
//     order (key descending, index ascending) is total), so the next level
//     selects again over the slices' survivors, until one CTA holds a whole
//     row; there it sorts its K survivors by (key descending, index
//     ascending) by rank and writes the scores, read again by index, and the
//     indices.
//
// Where a row fits one CTA (YOLOv1's 1,960 scores, v2's 16,900) the select is
// one launch, one CTA an image. YOLOv3-608's rows take 75 slices, then one
// CTA a row over 75 x 256 survivors: two launches. The wrapper
// (postprocess/cuda_topk.py) computes the levels from the shape alone and
// passes them in `plan`; the plain twin (postprocess/nms.py::
// topk_select_torch) repeats every step above in PyTorch.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kMaxSlice = 24576;  // keys a CTA holds: 96 KB, two CTAs an SM
constexpr int kMaxLevels = 8;
constexpr int kBins = 2048;       // the widest digit: 11 bits
// a thread's contiguous range of a slice fits a 64-bit mask
static_assert((((kMaxSlice + kThreads - 1) / kThreads + 3) & ~7) + 4 <= 64, "range > 64 keys");

// The order-preserving map of an f32 score to 32 bits: negatives below
// positives, -0.0 as +0.0, every NaN above +inf. Key 0 is no score's key
// (-inf maps to 0x007fffff), so it marks padding.
__device__ __forceinline__ uint32_t score_key(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Asynchronous copies from device to shared memory, and the wait for the
// calling thread's own (each thread then reads only what it copied).
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Exclusive prefix sum of v over the block. scratch holds kWarps words,
// which it rewrites only after the caller's next barrier; every thread must
// call it.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t v, uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? scratch[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) scratch[lane] = w;
  }
  __syncthreads();
  return (warp ? scratch[warp - 1] : 0u) + x - v;
}

// The select's digits, most significant first: 11, 11 and 10 bits.
__device__ __forceinline__ int digit_shift(int d) { return d == 0 ? 21 : d == 1 ? 10 : 0; }
__device__ __forceinline__ int digit_bins(int d) { return d == 2 ? 1024 : 2048; }

// A radix select in progress: the digits chosen so far (prefix, under
// mask) and the rank still sought among the keys that share them. For
// each digit, every thread counts its keys into the histogram, then, after
// a barrier, choose() takes the bucket that holds the rank-th largest, by
// a prefix sum over the bins from the top. hist (kBins words) is zero
// before the first count and after each choose(): each thread clears the
// bins it read. scratch holds kWarps + 2 words. Three barriers a digit.
struct Radix {
  uint32_t prefix, mask, rem;

  __device__ __forceinline__ void count(uint32_t x, int d, uint32_t* hist) const {
    if ((x & mask) == prefix)
      atomicAdd(&hist[(x >> digit_shift(d)) & (digit_bins(d) - 1)], 1u);
  }

  __device__ void choose(int d, uint32_t* hist, uint32_t* scratch) {
    // thread t holds bins hi - 1, ..., hi - per, the top bins on thread 0
    const int bins = digit_bins(d);
    const int per = bins / kThreads;
    const int hi = bins - static_cast<int>(threadIdx.x) * per;
    uint32_t c[kBins / kThreads];
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < kBins / kThreads; ++j) {
      c[j] = j < per ? hist[hi - 1 - j] : 0u;
      mine += c[j];
      if (j < per) hist[hi - 1 - j] = 0u;
    }
    uint32_t above = block_exclusive_sum(mine, scratch);
    if (above < rem && rem <= above + mine) {  // exactly one thread
#pragma unroll
      for (int j = 0; j < kBins / kThreads; ++j) {
        if (rem <= above + c[j]) {
          scratch[kWarps] = static_cast<uint32_t>(hi - 1 - j);
          scratch[kWarps + 1] = rem - above;
          break;
        }
        above += c[j];
      }
    }
    __syncthreads();
    prefix |= scratch[kWarps] << digit_shift(d);
    rem = scratch[kWarps + 1];
    mask |= static_cast<uint32_t>(bins - 1) << digit_shift(d);
  }
};

__device__ __forceinline__ int lowest_bit(uint64_t m) {
  return __ffsll(static_cast<long long>(m)) - 1;
}

// One CTA a (slice, row). kRaw: the slice is f32 scores (rows, length);
// else it is the previous level's survivors, keys and indices (rows,
// in_stride) of which `count` a row are filled. kFinal: the CTA holds the
// whole row and writes its K survivors sorted to vals and idx (rows, k);
// else it writes its min(k, slice) survivors, in index order, to
// out_keys/out_idx at row * out_stride + slice * k.
template <bool kRaw, bool kFinal>
__global__ void __launch_bounds__(kThreads, 2)
topk_select_kernel(const float* __restrict__ scores, int length,
                   const uint32_t* __restrict__ in_keys, const int32_t* __restrict__ in_idx,
                   int in_stride, int count, int slice_len, int k, int vec,
                   uint32_t* __restrict__ out_keys, int32_t* __restrict__ out_idx,
                   int out_stride, float* __restrict__ vals, int64_t* __restrict__ idx) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int slice_pad = (slice_len + 3) & ~3;
  uint32_t* keys = smem;
  uint32_t* hist = keys + slice_pad;
  uint32_t* scratch = hist + kBins;  // kWarps + 2 words, 32 reserved
  uint32_t* sk = scratch + 32;       // kFinal: the survivors' keys
  int32_t* si = reinterpret_cast<int32_t*>(sk + kMaxK);

  const int row = blockIdx.y;
  const int p0 = blockIdx.x * slice_len;
  const int total_n = kRaw ? length : count;
  const int n = min(slice_len, total_n - p0);
  const int ks = min(k, n);
  const int n4 = (n + 3) >> 2;

  // load: keys in shared memory, each load group's largest key
  uint32_t tmax = 0;
  uint4* keys4 = reinterpret_cast<uint4*>(keys);
  if (kRaw && vec) {  // 16-byte aligned rows and slices, n % 4 == 0
    const float4* src =
        reinterpret_cast<const float4*>(scores + static_cast<size_t>(row) * length + p0);
    for (int i = threadIdx.x; i < n4; i += kThreads) copy_async16(keys4 + i, src + i);
    copy_async_wait();
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 v = reinterpret_cast<const float4*>(keys4)[i];
      const uint4 q = {score_key(v.x), score_key(v.y), score_key(v.z), score_key(v.w)};
      keys4[i] = q;
      tmax = max(tmax, max(max(q.x, q.y), max(q.z, q.w)));
    }
  } else {  // unaligned scores, or the previous level's keys (in L2)
    const float* fs = kRaw ? scores + static_cast<size_t>(row) * length + p0 : nullptr;
    const uint32_t* us = kRaw ? nullptr : in_keys + static_cast<size_t>(row) * in_stride + p0;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * i + j;
        q[j] = p < n ? (kRaw ? score_key(fs[p]) : us[p]) : 0u;
        tmax = max(tmax, q[j]);
      }
      keys4[i] = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
  for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0u;
  __syncthreads();

  // the floor: the ks-th largest of the non-empty load groups' maxima, its
  // top 22 bits (two digits), where ks groups are not empty
  uint32_t floor = 1u;
  if (ks <= min(kThreads, n4)) {
    Radix r = {0u, 0u, static_cast<uint32_t>(ks)};
    for (int d = 0; d < 2; ++d) {
      if (tmax) r.count(tmax, d, hist);
      __syncthreads();
      r.choose(d, hist, scratch);
    }
    floor = max(1u, r.prefix);
  }

  // the ks-th largest key t of the slice: one pass over each thread's
  // contiguous range counts the first digit of the keys >= floor and marks
  // them in a mask (bit j: position b0 + j); the later digits and the
  // survivors read only the marked keys. A range length of 4 modulo 8 keeps
  // its 16-byte reads free of bank conflicts; the padding's zeros are
  // below every floor.
  const int c = (((n + kThreads - 1) / kThreads + 3) & ~7) + 4;
  const int b0 = min(static_cast<int>(threadIdx.x) * c, n);
  const int b1 = min(b0 + c, n);
  Radix r = {0u, 0u, static_cast<uint32_t>(ks)};
  uint64_t live = 0;
  for (int p = b0; p < b1; p += 4) {
    const uint4 v = keys4[p >> 2];
    const uint32_t xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (xs[j] >= floor) {
        live |= 1ull << (p - b0 + j);
        r.count(xs[j], 0, hist);
      }
    }
  }
  for (int d = 0; d < 3; ++d) {
    if (d > 0)
      for (uint64_t m = live; m; m &= m - 1) r.count(keys[b0 + lowest_bit(m)], d, hist);
    __syncthreads();
    r.choose(d, hist, scratch);
  }
  const uint32_t t = r.prefix, rem = r.rem;

  // survivors in index order: every key > t, and the first `rem` keys == t,
  // placed by a prefix sum over the threads' ranges
  uint64_t keep = 0;
  uint32_t gt = 0, eq = 0;
  for (uint64_t m = live; m; m &= m - 1) {
    const int j = lowest_bit(m);
    const uint32_t x = keys[b0 + j];
    if (x >= t) {
      keep |= 1ull << j;
      gt += x > t;
      eq += x == t;
    }
  }
  const uint32_t before = block_exclusive_sum((gt << 16) | eq, scratch);
  uint32_t g = before >> 16, e = before & 0xffffu;
  for (uint64_t m = keep; m; m &= m - 1) {
    const int p = b0 + lowest_bit(m);
    const uint32_t x = keys[p];
    int o = -1;
    if (x > t) {
      o = static_cast<int>(g + min(e, rem));
      ++g;
    } else {
      if (e < rem) o = static_cast<int>(g + e);
      ++e;
    }
    if (o < 0) continue;
    const int32_t ix = kRaw ? p0 + p : in_idx[static_cast<size_t>(row) * in_stride + p0 + p];
    if (kFinal) {
      sk[o] = x;
      si[o] = ix;
    } else {
      const size_t at =
          static_cast<size_t>(row) * out_stride + static_cast<size_t>(blockIdx.x) * k + o;
      out_keys[at] = x;
      out_idx[at] = ix;
    }
  }
  if (!kFinal) return;

  // one row's survivors: rank by (key descending, index ascending), each
  // survivor's count split over `per` neighbouring threads
  __syncthreads();
  int per = 1;
  while (per < 32 && 2 * per * ks <= kThreads) per *= 2;
  const int sub = threadIdx.x % per;
  for (int base = 0; base < ks; base += kThreads / per) {  // the same trips on every lane
    const int i = base + static_cast<int>(threadIdx.x) / per;
    const bool on = i < ks;
    const uint32_t x = on ? sk[i] : 0u;
    const int32_t ix = on ? si[i] : 0;
    int r = 0;
    if (on) {
      for (int j = sub; j < ks; j += per) {
        const uint32_t y = sk[j];
        r += (y > x) | ((y == x) & (si[j] < ix));
      }
    }
    for (int o = 1; o < per; o <<= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
    if (on && sub == 0) {
      const size_t at = static_cast<size_t>(row) * k + r;
      idx[at] = ix;
      vals[at] = scores[static_cast<size_t>(row) * length + ix];
    }
  }
}

// the keys a level leaves for the next: min(k, slice) a slice
int survivors(int n, int slices, int slice_len, int k) {
  const int last = n - (slices - 1) * slice_len;
  return (slices - 1) * k + (last < k ? last : k);
}

size_t smem_bytes(int slice_len, bool final_level) {
  const size_t words = ((slice_len + 3) & ~3) + kBins + 32 + (final_level ? 2 * kMaxK : 0);
  return words * sizeof(uint32_t);
}

template <bool kRaw, bool kFinal>
cudaError_t launch_level(int rows, int slices, const float* scores, int length,
                         const uint32_t* in_keys, const int32_t* in_idx, int in_stride,
                         int count, int slice_len, int k, int vec, uint32_t* out_keys,
                         int32_t* out_idx, int out_stride, float* vals, int64_t* idx,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes(slice_len, kFinal);
  // all of the SM's unified memory as shared memory: two CTAs an SM
  cudaError_t err = cudaFuncSetAttribute(topk_select_kernel<kRaw, kFinal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(topk_select_kernel<kRaw, kFinal>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  topk_select_kernel<kRaw, kFinal><<<dim3(slices, rows), kThreads, smem, stream>>>(
      scores, length, in_keys, in_idx, in_stride, count, slice_len, k, vec, out_keys,
      out_idx, out_stride, vals, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// scores (rows, length) f32 -> vals (rows, k) f32 and idx (rows, k) int64,
// sorted as torch.sort(descending, stable)'s first k columns. plan holds
// (slices, slice_len) for each of `levels` levels, the last one (1, count).
// Level l < levels - 1 writes its survivors to the scratch pair l % 2:
// keys_a/idx_a and keys_b/idx_b, each rows * slices_l * k words.
int topk_select_launch(const float* scores, int rows, int length, int k, const int* plan,
                       int levels, uint32_t* keys_a, int32_t* idx_a, uint32_t* keys_b,
                       int32_t* idx_b, float* vals, int64_t* idx, cudaStream_t stream) {
  if (rows <= 0 || rows > 65535 || k <= 0 || k > kMaxK || k > length || levels <= 0 ||
      levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan must cover each level's keys, and end in one slice a row
  int n = length;
  for (int l = 0; l < levels; ++l) {
    const int s = plan[2 * l], ls = plan[2 * l + 1];
    const bool last = l == levels - 1;
    if (s <= 0 || ls <= 0 || ls > kMaxSlice || (last && (s != 1 || ls < n)) ||
        static_cast<long long>(s - 1) * ls >= n || static_cast<long long>(s) * ls < n ||
        (!last && (ls % 4 || static_cast<long long>(s) * k > INT_MAX / rows)))
      return static_cast<int>(cudaErrorInvalidValue);
    n = survivors(n, s, ls, k);
  }
  const int vec = (reinterpret_cast<uintptr_t>(scores) % 16 == 0 && length % 4 == 0 &&
                   (levels == 1 || plan[1] % 4 == 0));
  uint32_t* out_keys[2] = {keys_a, keys_b};
  int32_t* out_idx[2] = {idx_a, idx_b};
  n = length;
  cudaError_t err = cudaSuccess;
  for (int l = 0; l < levels && err == cudaSuccess; ++l) {
    const int s = plan[2 * l], ls = plan[2 * l + 1];
    const bool raw = l == 0, last = l == levels - 1;
    const uint32_t* ik = raw ? nullptr : out_keys[(l - 1) % 2];
    const int32_t* ii = raw ? nullptr : out_idx[(l - 1) % 2];
    const int in_stride = raw ? 0 : plan[2 * (l - 1)] * k;
    uint32_t* ok = last ? nullptr : out_keys[l % 2];
    int32_t* oi = last ? nullptr : out_idx[l % 2];
    const int out_stride = s * k;
    if (raw && last)
      err = launch_level<true, true>(rows, s, scores, length, ik, ii, in_stride, n, ls, k,
                                     vec, ok, oi, out_stride, vals, idx, stream);
    else if (raw)
      err = launch_level<true, false>(rows, s, scores, length, ik, ii, in_stride, n, ls, k,
                                      vec, ok, oi, out_stride, vals, idx, stream);
    else if (last)
      err = launch_level<false, true>(rows, s, scores, length, ik, ii, in_stride, n, ls, k,
                                      0, ok, oi, out_stride, vals, idx, stream);
    else
      err = launch_level<false, false>(rows, s, scores, length, ik, ii, in_stride, n, ls,
                                       k, 0, ok, oi, out_stride, vals, idx, stream);
    n = survivors(n, s, ls, k);
  }
  return static_cast<int>(err);
}

const char* topk_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
