// Fused inference stem for Hopper (sm_90a): conv0 (3x3, 3 -> 32, stride 1,
// zero pad 1) + bias + leaky 0.1 + 2x2/2 max-pool in one pass, reading the
// f32 NHWC image batch and writing the pooled map as bf16 NHWC.
//
// Replaces yolojax/nn/pallas_stem.py::stem_forward_pallas (kernel body
// _stem_kernel). It computes that function, not its block structure:
//
//   out[n, a, b, co] = bf16( max over (di, dj) in {0,1}^2 of
//       leaky( bias[co] + sum_{u,v,c} w0[u,v,c,co] * x[n, 2a+di+u-1, 2b+dj+v-1, c] ) )
//
// with x and w0 rounded to bf16, the sum, bias, leaky and max in f32, and
// one rounding to bf16 at the end. The TPU kernel packed the input
// space-to-depth and the kernel into (3, 3, 12, 128) for its matrix unit;
// here the conv is a GEMM of the 27 taps that carry weight.
//
// What bounds it on this card: bytes. At b128@416 it must read 266 MB of
// f32 input and write 354 MB of bf16 output (0.185 ms at 3.35 TB/s). Its
// 38.3 GFLOP need 21% of the dense bf16 tensor-core peak to stay under
// that, which the f32 CUDA cores cannot give. So:
//
//   * the products run on the tensor cores, mma.sync m16n8k16 bf16 -> f32.
//     M is conv output pixels, K the 27 taps padded to 32 (two k-steps),
//     N the 32 channels (four n-tiles). B (32 x 32 bf16) is laid out in
//     per-lane fragment order once on the host (nn/stem.py::
//     stem_mma_operand) and each thread holds its 16 registers of it for
//     the whole kernel;
//   * pooling needs no shuffle: in M tile di, row g is pooled pixel g at
//     phase (di, 0) and row g + 8 the same pixel at phase (di, 1). A
//     thread's C fragments of the two tiles then hold all four phases of
//     its pixel, so bias + leaky + max run over registers;
//   * the K order is chosen for the gather: K slots 2p, 2p + 1 hold taps j
//     and j + 1 of tap row u (p = 5u + j/2, j = 3v + c), two neighbouring
//     floats of one input row (nn/stem.py::STEM_K_TAPS). Each staged window
//     is rounded to bf16 once, into two copies offset by one float, so
//     every A register is one aligned 32-bit shared load;
//   * the epilogue takes the max of the four phases first, then adds the
//     bias and applies leaky once a channel: f32 rounding and leaky are
//     monotone, so that equals the plain version's leaky-then-max exactly;
//   * input is staged asynchronously: a persistent grid (six 128-thread
//     blocks an SM) walks over tiles of 8 pooled rows x 16 pooled columns; a
//     2-stage ring of 18 input rows x 34 columns is filled with cp.async
//     (16 B where a row is 16-byte aligned, 4 B at the edges and when W is
//     not a multiple of 4), one tile ahead of the one being multiplied. The
//     conv's zero padding and ragged edges are zeros written into the ring;
//   * the output goes through a small per-warp staging area, so each warp
//     writes its 8 pooled pixels x 64 B as one contiguous 512 B store.
//
// On an H100 this layout still runs well above the bytes bound (PERF.md
// gives the time): with the copies or the arithmetic taken out, each half
// alone takes more than half of the kernel's time, so the two overlap only
// in part. Tile shapes, stage counts, blocks an SM and direct output stores
// each moved it little; a warp-specialised TMA producer is the next step.
//
// Floating point: the bf16 x bf16 products are exact in f32, but the tensor
// core sums them in its own order (and may truncate), not in the plain
// version's sequential order (yolojax_torch/nn/stem.py::stem_fused_torch).
// So the two are not bit-equal; the bound is nn/stem.py::stem_tolerance:
// one bf16 ulp of the result plus 2^-17 (|b| + max|x| sum|w0|), i.e. 27
// additions each off by at most one f32 ulp of the running magnitude, with
// a margin of 2.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCo = 32;                    // output channels (Darknet conv0)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileR = 8;                  // pooled rows per tile
constexpr int kTileC = 16;                 // pooled columns per tile
constexpr int kGroups = kTileC / 8;        // groups of 8 pooled pixels a row
constexpr int kItems = kTileR * kGroups;   // warp work items a tile
constexpr int kRows = 2 * kTileR + 2;      // staged input rows
constexpr int kCols = 2 * kTileC + 2;      // staged input columns
// floats a staged row: the window's 3 * kCols, the 16-byte shift and W1's
// last pair, rounded to whole 16-byte chunks
constexpr int kSlot = 120;
static_assert(kSlot >= 3 * kCols + 8 && kSlot % 4 == 0, "staged row too short");
constexpr int kChunks = kSlot / 4;
constexpr int kStages = 2;
constexpr int kStageFloats = kRows * kSlot;
constexpr int kOutStride = 20;             // u32 a staged output pixel (16 used)
// bf16 pairs a row of the converted window: W0 word m holds window floats
// (2m, 2m+1), W1 word m floats (2m+1, 2m+2), so every tap pair is one aligned
// 32-bit load from one of the two; the widest read is float 3 * kCols + 1
constexpr int kWinWords = (3 * kCols + 4) / 2;
constexpr int kWinTotal = kRows * kWinWords;
constexpr size_t kSmemBytes = static_cast<size_t>(kStages) * kStageFloats * 4 +
                              2 * static_cast<size_t>(kWinTotal) * 4 +
                              kWarps * 8 * kOutStride * 4;
constexpr int kFragRegs = 16;              // B fragment registers a lane
constexpr int kMinBlocks = 6;             // blocks an SM: 80 registers or fewer
// under the default 48 KB of dynamic shared memory a block, and six blocks
// fit in an SM's 228 KB, so the launch needs no attribute set
static_assert(kSmemBytes <= 48 * 1024 && kMinBlocks * kSmemBytes <= 227 * 1024,
              "stem staging does not fit");

struct Tile {
  int img, r0, c0;  // image, first pooled row, first pooled column
};

__device__ __forceinline__ Tile decode(int t, int bands, int ctiles) {
  const int ct = t % ctiles;
  t /= ctiles;
  return {t / bands, (t % bands) * kTileR, ct * kTileC};
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage the input window of tile tl: slot row r holds image row 2*r0-1+r;
// slot position d holds float g0 - shift + d of the image batch, where g0 is
// the float index of (row, column 2*c0-1, channel 0). Positions of the
// window that lie outside the image (the conv's padding, ragged edges) get
// zeros; whole 16-byte chunks inside it go by one 16-byte copy when vec.
__device__ __forceinline__ void issue_tile(float* stage, const float* __restrict__ x,
                                           const Tile& tl, int h, int w, bool vec,
                                           int shift) {
  const int y0 = 2 * tl.r0 - 1;
  const int xs = 2 * tl.c0 - 1;
  const int fa = (max(xs, 0) - xs) * 3;       // valid floats of a row: [fa, fb)
  const int fb = (min(xs + kCols, w) - xs) * 3;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kRows; r += kWarps) {
    const int y = y0 + r;
    const bool row_in = y >= 0 && y < h;
    // float (y, xs, 0); dereferenced only inside [fa, fb)
    const float* src = x + ((static_cast<long long>(tl.img) * h + y) * w + xs) * 3;
    float* dst_row = stage + r * kSlot;
    for (int q = lane; q < kChunks; q += 32) {
      const int rel = 4 * q - shift;  // position - shift, relative to src
      float* dst = dst_row + 4 * q;
      if (row_in && vec && rel >= fa && rel + 4 <= fb) {
        cp_async16(dst, src + rel);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = rel + e;
        if (row_in && f >= fa && f < fb)
          cp_async4(dst + e, src + f);
        else if (f >= 0 && f < 3 * kCols + 5)  // the window and W1's last pair
          dst[e] = 0.0f;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
stem_fused_kernel(const float* __restrict__ x, const uint32_t* __restrict__ wfrag,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                  int h, int w, int bands, int ctiles, int tiles, bool vec,
                  int shift) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;    // mma row group: pooled pixel of the group
  const int tig = lane & 3;   // thread in group: k pair and channel pair
  const int hp = h / 2, wq = w / 2;

  // B fragments: register (ks * 4 + nt) * 2 + half
  uint32_t bfrag[kFragRegs];
#pragma unroll
  for (int r = 0; r < kFragRegs; ++r) bfrag[r] = wfrag[r * 32 + lane];
  float bv[4][2];  // bias of channels nt * 8 + 2 * tig + e
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[nt][e] = bias[nt * 8 + 2 * tig + e];
  // pair q of this lane is tap pair p = 4q + tig: K slots 2p, 2p + 1 hold
  // (u, j), (u, j + 1) with u = p / 5, j = 2 (p % 5) (nn/stem.py::
  // STEM_K_TAPS; j = 9 and p = 15 are padding against zero rows of B).
  // off[q]: its word offset from the pixel's first word in the window.
  int off[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int p = min(4 * q + tig, 14);
    off[q] = (p / 5) * kWinWords + p % 5;
  }

  uint32_t* win0 = reinterpret_cast<uint32_t*>(smem + kStages * kStageFloats);
  uint32_t* win1 = win0 + kWinTotal;
  uint32_t* ostage = win1 + kWinTotal + warp * 8 * kOutStride;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const long long t = blockIdx.x + static_cast<long long>(s) * gridDim.x;
    if (t < tiles)
      issue_tile(smem + s * kStageFloats, x, decode(static_cast<int>(t), bands, ctiles),
                 h, w, vec, shift);
    cp_async_commit();
  }

  int stage = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long tn = t + static_cast<long long>(kStages - 1) * gridDim.x;
    if (tn < tiles) {
      const int sn = (stage + kStages - 1) % kStages;
      issue_tile(smem + sn * kStageFloats, x, decode(static_cast<int>(tn), bands, ctiles),
                 h, w, vec, shift);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile t's window is in place for every thread

    // round the window to bf16 pairs once: W0 aligned for phase dj = 0, W1
    // (shifted by one float) for dj = 1
    const float* stg = smem + stage * kStageFloats + shift;
    for (int i = threadIdx.x; i < kWinTotal; i += kThreads) {
      const int r = i / kWinWords;
      const float* f = stg + r * kSlot + 2 * (i - r * kWinWords);
      win0[i] = pack_bf16(f[0], f[1]);
      win1[i] = pack_bf16(f[1], f[2]);
    }
    __syncthreads();

    const Tile tl = decode(t, bands, ctiles);
    for (int item = warp; item < kItems; item += kWarps) {
      const int rl = item / kGroups;
      const int grp = item - rl * kGroups;
      const int row = tl.r0 + rl;
      const int col0 = tl.c0 + grp * 8;
      if (row >= hp || col0 >= wq) continue;  // the same for the whole warp
      const int pl = grp * 8 + g;             // this lane's pooled column in the tile

      float acc[2][4][4];
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[di][nt][e] = 0.0f;

#pragma unroll
      for (int di = 0; di < 2; ++di) {
        // a[dj][q]: row g (dj = 0) / g + 8 (dj = 1), tap pair 4q + tig; the
        // pixel's window floats start at 6 pl + 3 dj: word 3 pl of W0, or
        // word 3 pl + 1 of W1
        uint32_t a[2][4];
        const int base = (2 * rl + di) * kWinWords + 3 * pl;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[0][q] = win0[base + off[q]];
          a[1][q] = win1[base + 1 + off[q]];
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[di][nt], a[0][2 * ks], a[1][2 * ks], a[0][2 * ks + 1],
                     a[1][2 * ks + 1], bfrag[(ks * 4 + nt) * 2], bfrag[(ks * 4 + nt) * 2 + 1]);
      }

      // the max over the four phases, bias and leaky, all in this thread.
      // f32 rounding and leaky are monotone, so leaky(max_p(acc_p) + b)
      // equals max_p leaky(acc_p + b), the plain version's order, exactly.
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float m[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = __fadd_rn(fmaxf(fmaxf(acc[0][nt][e], acc[0][nt][2 + e]),
                                          fmaxf(acc[1][nt][e], acc[1][nt][2 + e])),
                                    bv[nt][e]);
          m[e] = z >= 0.0f ? z : __fmul_rn(0.1f, z);
        }
        ostage[g * kOutStride + nt * 4 + tig] = pack_bf16(m[0], m[1]);
      }
      __syncwarp();
      // lane -> pixel lane / 4, 16-byte chunk lane % 4: 512 contiguous bytes
      const int px = lane >> 2;
      if (col0 + px < wq) {
        const uint4 v = *reinterpret_cast<const uint4*>(ostage + px * kOutStride + tig * 4);
        const size_t o =
            ((static_cast<size_t>(tl.img) * hp + row) * wq + col0 + px) * kCo + tig * 8;
        *reinterpret_cast<uint4*>(out + o) = v;
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with this stage before it refills
    stage = (stage + 1) % kStages;
  }
  cp_async_wait<0>();
}

}  // namespace

// x (n, h, w, 3) f32 NHWC; wfrag (16, 32) u32, the B fragments of
// nn/stem.py::stem_mma_operand; bias (32,) f32; out (n, h/2, w/2, 32) bf16.
extern "C" int stem_fused_launch(const float* x, const void* wfrag, const float* bias,
                                 void* out, int n, int h, int w, cudaStream_t stream) {
  if (n <= 0 || h < 2 || w < 2 || (h & 1) || (w & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bands = (h / 2 + kTileR - 1) / kTileR;
  const int ctiles = (w / 2 + kTileC - 1) / kTileC;
  const long long tiles = static_cast<long long>(n) * bands * ctiles;
  if (tiles > INT_MAX / 4) return static_cast<int>(cudaErrorInvalidValue);

  // the persistent grid: kMinBlocks blocks on every SM, as __launch_bounds__ fixes
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = std::min<long long>(tiles, static_cast<long long>(sms) * kMinBlocks);
  // 16-byte copies need every staged row to start at the same offset within
  // a 16-byte chunk: W a multiple of 4 and an aligned base. Then the float
  // index of (row, 2*c0-1, 0) is 1 mod 4 for every row (c0 is a multiple of
  // kTileC), so each window sits one float into its slot.
  const bool vec = (w % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int shift = vec ? 1 : 0;
  stem_fused_kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes, stream>>>(
      x, static_cast<const uint32_t*>(wfrag), bias, static_cast<__nv_bfloat16*>(out), h, w,
      bands, ctiles, static_cast<int>(tiles), vec, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stem_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
