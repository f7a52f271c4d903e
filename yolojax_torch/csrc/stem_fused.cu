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
// with x and w0 rounded to bf16 on load, the sum, bias, leaky and max in
// f32, and one rounding to bf16 at the end. The TPU kernel packed the input
// space-to-depth and the kernel into (3, 3, 12, 128) to fill its matrix
// unit's lanes; three quarters of that packed kernel are zeros. Here the
// wrapper hands over the unpacked w0 (3, 3, 3, 32), recovered once from
// the packed kernel, and the kernel does only the 27 x 4 products per
// pooled pixel and channel that carry weight. There is no cast pass and no
// packing pass: the f32 input is read once and rounded as it is staged.
// The output is NHWC (the next conv takes it as a channels_last view); the
// TPU kernel's "NHCW" was a VMEM layout choice.
//
// What bounds it on this card: bytes. At b128@416 it must read 266 MB of
// f32 input and write 354 MB of bf16 output (0.185 ms at 3.35 TB/s); its
// 38 GFLOP would take 0.039 ms at the bf16 tensor-core peak. This first
// version is the simple kernel: f32 CUDA cores, one thread per pooled pixel
// and group of 8 output channels, so it is bound by its f32 instructions,
// not by bytes: 38.3 G separate multiplies and adds at b128@416, 1.14 ms at
// the card's f32 issue rate. A tensor-core (wgmma) version is later work.
//
// Design:
//   * a block covers 32 pooled columns x 8 pooled rows of one image, two
//     pooled rows at a time; 256 threads = 2 rows x 32 columns x 4 channel
//     groups. For each row pair the block stages the 6 x 66 x 3 input
//     window it needs in shared memory (zero outside the image: the conv's
//     padding), rounded to bf16; consecutive threads load consecutive
//     floats, so the loads coalesce;
//   * the weights (bf16-rounded) and the bias sit in shared memory; the
//     four threads of one pixel read different channel groups, the eight
//     pixels of a warp the same addresses (broadcast);
//   * each thread keeps its 4 x 4 x 3 input window and 4 phases x 8
//     accumulators in registers, then bias, leaky and the phase max, and
//     writes its 8 channels as one 16-byte store: a warp writes 2 KB of
//     contiguous output.
//
// Floating point: the products are added in the order of the packed conv
// that the plain version (yolojax_torch/nn/stem.py::stem_fused_torch) runs
// (packed tap u', v', then packed channel (si*2+sj)*3+c), each as one
// __fmul_rn and one __fadd_rn. nvcc never contracts those intrinsics into
// an FMA, so the file needs no -fmad=false, and the result equals the plain
// version bit for bit (the packed kernel's zeros add exact zeros there).

#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCo = 32;                  // output channels (Darknet conv0)
constexpr int kCg = 8;                   // output channels per thread
constexpr int kGroups = kCo / kCg;       // channel groups per pixel
constexpr int kTileC = 32;               // pooled columns per block
constexpr int kRowsPerIter = 2;          // pooled rows per staged window
constexpr int kIters = 4;                // row pairs per block
constexpr int kRowsPerBlock = kRowsPerIter * kIters;
constexpr int kThreads = kGroups * kTileC * kRowsPerIter;  // 256
constexpr int kWinR = 2 * kRowsPerIter + 2;                // input rows staged
constexpr int kWinC = 2 * kTileC + 2;                      // input cols staged
constexpr int kTaps = 27;                                  // 3 x 3 x 3

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads)
stem_fused_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                  int h, int w, int tiles_r, int tiles_c) {
  __shared__ __align__(16) float sw[kTaps * kCo];  // [u][v][c][co]
  __shared__ __align__(16) float sb[kCo];
  __shared__ float sx[kWinR][kWinC][3];

  const int tid = threadIdx.x;
  for (int i = tid; i < kTaps * kCo; i += kThreads) sw[i] = round_bf16(w0[i]);
  if (tid < kCo) sb[tid] = bias[tid];

  int blk = blockIdx.x;
  const int tc = blk % tiles_c;
  blk /= tiles_c;
  const int tr = blk % tiles_r;
  const int img = blk / tiles_r;
  const int hp = h / 2, wq = w / 2;
  const int g = tid % kGroups;
  const int pc = (tid / kGroups) % kTileC;
  const int pr = tid / (kGroups * kTileC);
  const int col = tc * kTileC + pc;
  const float* xi = x + static_cast<size_t>(img) * h * w * 3;

  for (int it = 0; it < kIters; ++it) {
    const int r0 = tr * kRowsPerBlock + it * kRowsPerIter;  // first pooled row
    if (r0 >= hp) break;  // the same for every thread of the block
    __syncthreads();      // the window's last readers are done (and sw is set)
    const int y0 = 2 * r0 - 1;
    const int x0 = 2 * tc * kTileC - 1;
    for (int i = tid; i < kWinR * kWinC * 3; i += kThreads) {
      const int c = i % 3;
      const int q = i / 3;
      const int cc = q % kWinC;
      const int rr = q / kWinC;
      const int yy = y0 + rr, xx = x0 + cc;
      float v = 0.0f;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        v = round_bf16(xi[(static_cast<size_t>(yy) * w + xx) * 3 + c]);
      sx[rr][cc][c] = v;
    }
    __syncthreads();

    const int row = r0 + pr;
    if (row >= hp || col >= wq) continue;

    // input rows 2*row-1 .. 2*row+2 and cols 2*col-1 .. 2*col+2
    float win[4][4][3];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int c = 0; c < 3; ++c) win[a][b][c] = sx[2 * pr + a][2 * pc + b][c];

    float acc[4][kCg];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int k = 0; k < kCg; ++k) acc[p][k] = 0.0f;

    // The packed conv's order: tap (up, vp) of the packed 3x3, then packed
    // channel (si*2+sj)*3+c. That packed input value is the image pixel at
    // row offset 2*up-2+si and column offset 2*vp-2+sj from (2a, 2b); for
    // phase (di, dj) it meets w0[u][v][c] with u = off_r - di + 1 and
    // v = off_c - dj + 1 when both lie in 0..2 (elsewhere the packed kernel
    // holds a zero). Every condition below is known at compile time.
#pragma unroll
    for (int up = 0; up < 3; ++up)
#pragma unroll
      for (int vp = 0; vp < 3; ++vp)
#pragma unroll
        for (int si = 0; si < 2; ++si)
#pragma unroll
          for (int sj = 0; sj < 2; ++sj)
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const int off_r = 2 * up - 2 + si;
              const int off_c = 2 * vp - 2 + sj;
              if (off_r < -1 || off_r > 2 || off_c < -1 || off_c > 2) continue;
              const float xv = win[off_r + 1][off_c + 1][c];
#pragma unroll
              for (int di = 0; di < 2; ++di)
#pragma unroll
                for (int dj = 0; dj < 2; ++dj) {
                  const int u = off_r - di + 1;
                  const int v = off_c - dj + 1;
                  if (u < 0 || u > 2 || v < 0 || v > 2) continue;
                  const float4* wr = reinterpret_cast<const float4*>(
                      &sw[((u * 3 + v) * 3 + c) * kCo + g * kCg]);
                  const float4 wa = wr[0];
                  const float4 wb = wr[1];
                  const float wk[kCg] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
                  float* ap = acc[di * 2 + dj];
#pragma unroll
                  for (int k = 0; k < kCg; ++k) ap[k] = __fadd_rn(ap[k], __fmul_rn(xv, wk[k]));
                }
            }

    uint4 packed;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int k = 0; k < kCg; k += 2) {
      float m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m[e] = -INFINITY;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float z = __fadd_rn(acc[p][k + e], sb[g * kCg + k + e]);
          z = z >= 0.0f ? z : __fmul_rn(0.1f, z);
          m[e] = fmaxf(m[e], z);
        }
      }
      o2[k / 2] = __floats2bfloat162_rn(m[0], m[1]);
    }
    const size_t o = ((static_cast<size_t>(img) * hp + row) * wq + col) * kCo + g * kCg;
    *reinterpret_cast<uint4*>(out + o) = packed;
  }
}

}  // namespace

extern "C" int stem_fused_launch(const float* x, const float* w0, const float* bias,
                                 void* out, int n, int h, int w, cudaStream_t stream) {
  if (n <= 0 || h < 2 || w < 2 || (h & 1) || (w & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_r = (h / 2 + kRowsPerBlock - 1) / kRowsPerBlock;
  const int tiles_c = (w / 2 + kTileC - 1) / kTileC;
  const long long blocks = static_cast<long long>(n) * tiles_r * tiles_c;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  stem_fused_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, w0, bias, static_cast<__nv_bfloat16*>(out), h, w, tiles_r, tiles_c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stem_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
