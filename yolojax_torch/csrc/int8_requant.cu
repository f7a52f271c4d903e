// One-pass int8 requant epilogue for Hopper (sm_90a).
//
// Replaces the epilogue that XLA fuses after each int8 product of
// yolojax/quantize/ptq.py::apply_int8 (yolojax has no Pallas kernel for it):
// the conv's dequant + bias + leaky + requant (ptq.py:363-368), and in the
// fused int8 stem the same followed by the max over the four pool phases
// (ptq.py:319-325). From the int32 sums acc (M, phases*C), row stride ld, it
// writes the int8 codes (M, C):
//
//   y = fma(float(acc), m[col], b[col])     m = f32(in_scale) * w_scale
//   y = y >= 0 ? y : 0.1f * y               (layers with leaky)
//   q = clamp(rint(y * r), -qmax, qmax)     r = f32(1) / f32(act_scale)
//   out[row, c] = max over g < phases of q[row, g*C + c]
//
// That is the recipe of jax.jit(apply_int8): XLA contracts the dequant and
// bias into one FMA, and replaces the division by the baked scale with a
// multiplication by its f32 reciprocal. Every step is written with a
// round-to-nearest intrinsic (__int2float_rn, __fmaf_rn, __fmul_rn, rintf,
// which rounds half to even like jnp.round), so nvcc's contraction cannot
// change it, and the codes equal the plain version
// (quantize/int8_ops.py::int8_requant_torch) bit for bit.
//
// What bounds it on this card: bytes. Each output code reads 4 * phases
// bytes of sums and writes one byte, plus the per-channel constants, with
// a handful of operations a value (~0.3 operations a byte, far below the
// card's ~20 f32 operations a byte). The design is the simple one: a grid
// of 256-thread blocks, eight an SM, strides over the outputs; consecutive
// threads take consecutive channels of a row, so the sums are read and the
// codes written in coalesced runs, and m and b come through the read-only
// cache. Each thread divides its first index once and then steps its
// (row, channel) pair without dividing. Fusing this pass into the product
// is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float code(int32_t acc, float m, float b, float r,
                                      float qmax, bool leaky) {
  float y = __fmaf_rn(__int2float_rn(acc), m, b);
  if (leaky) y = y >= 0.0f ? y : __fmul_rn(0.1f, y);
  const float q = rintf(__fmul_rn(y, r));
  return fminf(fmaxf(q, -qmax), qmax);
}

template <int kPhases, bool kLeaky>
__global__ void __launch_bounds__(kThreads)
int8_requant_kernel(const int32_t* __restrict__ acc, int64_t ld,
                    const float* __restrict__ m, const float* __restrict__ b,
                    int8_t* __restrict__ out, int64_t rows, int channels,
                    float r, float qmax) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t row = first / channels;
  int c = static_cast<int>(first - row * channels);
  const int64_t row_step = stride / channels;
  const int c_step = static_cast<int>(stride - row_step * channels);
  while (row < rows) {
    const int32_t* src = acc + row * ld;
    float q = code(src[c], __ldg(m + c), __ldg(b + c), r, qmax, kLeaky);
#pragma unroll
    for (int g = 1; g < kPhases; ++g) {
      const int col = g * channels + c;
      q = fmaxf(q, code(src[col], __ldg(m + col), __ldg(b + col), r, qmax,
                        kLeaky));
    }
    out[row * channels + c] = static_cast<int8_t>(static_cast<int>(q));
    row += row_step;
    c += c_step;
    if (c >= channels) {
      c -= channels;
      ++row;
    }
  }
}

template <int kPhases, bool kLeaky>
cudaError_t launch(const int32_t* acc, int64_t ld, const float* m,
                   const float* b, int8_t* out, int64_t rows, int channels,
                   float r, float qmax, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t total = rows * channels;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  int8_requant_kernel<kPhases, kLeaky><<<static_cast<unsigned>(blocks),
                                         kThreads, 0, stream>>>(
      acc, ld, m, b, out, rows, channels, r, qmax);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// acc (rows, ld) int32 holding phases * channels columns; m, b
// (phases * channels) f32; out (rows, channels) int8. phases is 1 or 4.
// Returns a cudaError_t (0 on success); the launch is asynchronous on stream.
int int8_requant_launch(const void* acc, long long ld, const void* m,
                        const void* b, void* out, long long rows, int channels,
                        int phases, float r, int qmax, int leaky,
                        void* stream) {
  if (rows <= 0 || channels <= 0) return cudaSuccess;
  if (phases != 1 && phases != 4) return cudaErrorInvalidValue;
  if (ld < static_cast<long long>(phases) * channels) return cudaErrorInvalidValue;
  const auto* a = static_cast<const int32_t*>(acc);
  const auto* mp = static_cast<const float*>(m);
  const auto* bp = static_cast<const float*>(b);
  auto* o = static_cast<int8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const float q = static_cast<float>(qmax);
  if (phases == 4) {
    return leaky ? launch<4, true>(a, ld, mp, bp, o, rows, channels, r, q, s)
                 : launch<4, false>(a, ld, mp, bp, o, rows, channels, r, q, s);
  }
  return leaky ? launch<1, true>(a, ld, mp, bp, o, rows, channels, r, q, s)
               : launch<1, false>(a, ld, mp, bp, o, rows, channels, r, q, s);
}

const char* int8_requant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
