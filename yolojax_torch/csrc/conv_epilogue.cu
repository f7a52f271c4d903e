// One-pass bf16 conv epilogue for Hopper (sm_90a).
//
// Replaces the epilogue that XLA fuses after each bf16 conv and dense
// product of yolojax/nn/layers.py::apply_network (yolojax has no Pallas
// kernel for it): the upcast, the folded bias or the eval-mode BN affine,
// leaky and the cast back (layers.py:395-420 for a conv, :431-440 for a
// dense layer). From the bf16 product y (rows, C), row stride ld, it writes
// z (rows, C) bf16, row-major:
//
//   v = float(y[row, c])                       exact
//   v = v + b[c]    or    v * s[c] + b[c]      (s: BN's rsqrt(var+eps)*scale)
//   v = v >= 0 ? v : alpha * v                 (layers with leaky)
//   z[row, c] = bf16(v)                        round to nearest even
//
// That is the plain version's sequence (nn/layers.py::conv_epilogue_torch),
// one rounding per operation: every step is a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __float2bfloat16_rn), so nvcc cannot contract
// v * s + b into an FMA, and z equals the plain version bit for bit (NaN
// payloads aside). The comparison is v >= 0.0f, so -0.0 and NaN take the
// branch torch.where takes.
//
// What bounds it on this card: bytes. Each element reads 2 B and writes
// 2 B, with 2 to 5 f32 operations (about one an element byte, far below
// the card's ~20 f32 operations a byte). The design is the simple one: a
// grid of 256-thread blocks, eight an SM, strides over the output. Where C,
// ld and every pointer allow it, a thread moves 8 channels (16 B) with one
// vector load and one vector store; otherwise (the v2 head has C = 125, a
// column slice may be unaligned) one element. Consecutive threads take
// consecutive channels of a row, so y is read and z written in coalesced
// runs, and b and s come through the read-only cache. Each thread divides
// its first index once and then steps its (row, channel) pair without
// dividing. Fusing this pass into the conv itself is later work.
//
// conv_epilogue_residual_kernel is the same pass for a conv that a residual
// shortcut follows (Darknet-53's blocks): it also reads r (rows, C) bf16,
// the shortcut's earlier output, and writes
//
//   z[row, c] = bf16(float(bf16(v)) + float(r[row, c]))
//
// the epilogue's bf16 output plus r, each rounding as the plain ops
// x.to(bf16) + r round, so z is again bit-equal to them. It moves 6 B a
// value where the epilogue and a separate add would move 10. It is a
// kernel of its own, so that a trace tells it from conv_epilogue_kernel;
// the latter's instantiations are unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <bool kScale, bool kLeaky>
__device__ __forceinline__ unsigned short apply(unsigned short y, float b,
                                                float s, float alpha) {
  float v = __bfloat162float(__ushort_as_bfloat16(y));
  v = kScale ? __fadd_rn(__fmul_rn(v, s), b) : __fadd_rn(v, b);
  if (kLeaky) v = v >= 0.0f ? v : __fmul_rn(alpha, v);
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

union Pack8 {
  uint4 vec;
  unsigned short h[8];
};

// kVec channels a thread: 8 (16-byte loads and stores) or 1.
template <int kVec, bool kScale, bool kLeaky>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(const unsigned short* __restrict__ y, int64_t ld,
                     const float* __restrict__ b, const float* __restrict__ s,
                     unsigned short* __restrict__ z, int64_t rows,
                     int channels, float alpha) {
  const int units = channels / kVec;  // vectors a row
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t row = first / units;
  int u = static_cast<int>(first - row * units);
  const int64_t row_step = stride / units;
  const int u_step = static_cast<int>(stride - row_step * units);
  while (row < rows) {
    const int c = u * kVec;
    const unsigned short* src = y + row * ld + c;
    unsigned short* dst = z + row * channels + c;
    if constexpr (kVec == 8) {
      Pack8 in, out;
      in.vec = *reinterpret_cast<const uint4*>(src);
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + c));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + c + 4));
      float4 s0 = make_float4(1.0f, 1.0f, 1.0f, 1.0f), s1 = s0;
      if (kScale) {
        s0 = __ldg(reinterpret_cast<const float4*>(s + c));
        s1 = __ldg(reinterpret_cast<const float4*>(s + c + 4));
      }
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float ss[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        out.h[i] = apply<kScale, kLeaky>(in.h[i], bb[i], ss[i], alpha);
      }
      *reinterpret_cast<uint4*>(dst) = out.vec;
    } else {
      *dst = apply<kScale, kLeaky>(*src, __ldg(b + c),
                                   kScale ? __ldg(s + c) : 1.0f, alpha);
    }
    row += row_step;
    u += u_step;
    if (u >= units) {
      u -= units;
      ++row;
    }
  }
}

__device__ __forceinline__ unsigned short add_bf16(unsigned short a,
                                                   unsigned short r) {
  const float v = __fadd_rn(__bfloat162float(__ushort_as_bfloat16(a)),
                            __bfloat162float(__ushort_as_bfloat16(r)));
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// conv_epilogue_kernel's loop, with r (rows, channels) row-major added
template <int kVec, bool kScale, bool kLeaky>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_residual_kernel(const unsigned short* __restrict__ y,
                              int64_t ld, const float* __restrict__ b,
                              const float* __restrict__ s,
                              const unsigned short* __restrict__ r,
                              unsigned short* __restrict__ z, int64_t rows,
                              int channels, float alpha) {
  const int units = channels / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t row = first / units;
  int u = static_cast<int>(first - row * units);
  const int64_t row_step = stride / units;
  const int u_step = static_cast<int>(stride - row_step * units);
  while (row < rows) {
    const int c = u * kVec;
    const unsigned short* src = y + row * ld + c;
    const int64_t at = row * channels + c;
    if constexpr (kVec == 8) {
      Pack8 in, res, out;
      in.vec = *reinterpret_cast<const uint4*>(src);
      res.vec = *reinterpret_cast<const uint4*>(r + at);
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + c));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + c + 4));
      float4 s0 = make_float4(1.0f, 1.0f, 1.0f, 1.0f), s1 = s0;
      if (kScale) {
        s0 = __ldg(reinterpret_cast<const float4*>(s + c));
        s1 = __ldg(reinterpret_cast<const float4*>(s + c + 4));
      }
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float ss[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        out.h[i] = add_bf16(apply<kScale, kLeaky>(in.h[i], bb[i], ss[i], alpha),
                            res.h[i]);
      }
      *reinterpret_cast<uint4*>(z + at) = out.vec;
    } else {
      z[at] = add_bf16(apply<kScale, kLeaky>(*src, __ldg(b + c),
                                             kScale ? __ldg(s + c) : 1.0f,
                                             alpha),
                       r[at]);
    }
    row += row_step;
    u += u_step;
    if (u >= units) {
      u -= units;
      ++row;
    }
  }
}

// blocks for `total` thread units: one a unit, at most kBlocksPerSm an SM
cudaError_t grid_blocks(int64_t total, int64_t* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (*blocks > cap) *blocks = cap;
  return cudaSuccess;
}

template <int kVec, bool kScale, bool kLeaky>
cudaError_t launch_residual(const unsigned short* y, int64_t ld,
                            const float* b, const float* s,
                            const unsigned short* r, unsigned short* z,
                            int64_t rows, int channels, float alpha,
                            cudaStream_t stream) {
  int64_t blocks = 0;
  cudaError_t err = grid_blocks(rows * (channels / kVec), &blocks);
  if (err != cudaSuccess) return err;
  conv_epilogue_residual_kernel<kVec, kScale, kLeaky>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          y, ld, b, s, r, z, rows, channels, alpha);
  return cudaGetLastError();
}

template <int kVec>
cudaError_t dispatch_residual(const unsigned short* y, int64_t ld,
                              const float* b, const float* s,
                              const unsigned short* r, unsigned short* z,
                              int64_t rows, int channels, float alpha,
                              bool leaky, cudaStream_t stream) {
  if (s != nullptr) {
    return leaky ? launch_residual<kVec, true, true>(y, ld, b, s, r, z, rows, channels, alpha, stream)
                 : launch_residual<kVec, true, false>(y, ld, b, s, r, z, rows, channels, alpha, stream);
  }
  return leaky ? launch_residual<kVec, false, true>(y, ld, b, s, r, z, rows, channels, alpha, stream)
               : launch_residual<kVec, false, false>(y, ld, b, s, r, z, rows, channels, alpha, stream);
}

template <int kVec, bool kScale, bool kLeaky>
cudaError_t launch(const unsigned short* y, int64_t ld, const float* b,
                   const float* s, unsigned short* z, int64_t rows,
                   int channels, float alpha, cudaStream_t stream) {
  int64_t blocks = 0;
  cudaError_t err = grid_blocks(rows * (channels / kVec), &blocks);
  if (err != cudaSuccess) return err;
  conv_epilogue_kernel<kVec, kScale, kLeaky>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          y, ld, b, s, z, rows, channels, alpha);
  return cudaGetLastError();
}

template <int kVec>
cudaError_t dispatch(const unsigned short* y, int64_t ld, const float* b,
                     const float* s, unsigned short* z, int64_t rows,
                     int channels, float alpha, bool leaky,
                     cudaStream_t stream) {
  if (s != nullptr) {
    return leaky ? launch<kVec, true, true>(y, ld, b, s, z, rows, channels, alpha, stream)
                 : launch<kVec, true, false>(y, ld, b, s, z, rows, channels, alpha, stream);
  }
  return leaky ? launch<kVec, false, true>(y, ld, b, s, z, rows, channels, alpha, stream)
               : launch<kVec, false, false>(y, ld, b, s, z, rows, channels, alpha, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// y (rows, ld) bf16 holding `channels` columns; b and, in BN mode, scale
// (channels) f32 (scale NULL for the bias mode); z (rows, channels) bf16.
// Returns a cudaError_t (0 on success); the launch is asynchronous on
// stream. The 8-channel path runs when channels and ld are multiples of 8
// and every pointer is 16-byte aligned.
int conv_epilogue_launch(const void* y, long long ld, const void* b,
                         const void* scale, void* z, long long rows,
                         int channels, float alpha, int leaky, void* stream) {
  if (rows <= 0 || channels <= 0) return cudaSuccess;
  if (ld < channels) return cudaErrorInvalidValue;
  const auto* yp = static_cast<const unsigned short*>(y);
  const auto* bp = static_cast<const float*>(b);
  const auto* sp = static_cast<const float*>(scale);
  auto* zp = static_cast<unsigned short*>(z);
  auto st = static_cast<cudaStream_t>(stream);
  if (channels % 8 == 0 && ld % 8 == 0 && aligned16(y) && aligned16(z)
      && aligned16(b) && (sp == nullptr || aligned16(scale))) {
    return dispatch<8>(yp, ld, bp, sp, zp, rows, channels, alpha, leaky != 0, st);
  }
  return dispatch<1>(yp, ld, bp, sp, zp, rows, channels, alpha, leaky != 0, st);
}

// The same, plus r (rows, channels) bf16 row-major added after the cast
// (conv_epilogue_residual_kernel). The 8-channel path also needs r 16-byte
// aligned.
int conv_epilogue_residual_launch(const void* y, long long ld, const void* b,
                                  const void* scale, const void* r, void* z,
                                  long long rows, int channels, float alpha,
                                  int leaky, void* stream) {
  if (rows <= 0 || channels <= 0) return cudaSuccess;
  if (ld < channels || r == nullptr) return cudaErrorInvalidValue;
  const auto* yp = static_cast<const unsigned short*>(y);
  const auto* bp = static_cast<const float*>(b);
  const auto* sp = static_cast<const float*>(scale);
  const auto* rp = static_cast<const unsigned short*>(r);
  auto* zp = static_cast<unsigned short*>(z);
  auto st = static_cast<cudaStream_t>(stream);
  if (channels % 8 == 0 && ld % 8 == 0 && aligned16(y) && aligned16(z)
      && aligned16(r) && aligned16(b)
      && (sp == nullptr || aligned16(scale))) {
    return dispatch_residual<8>(yp, ld, bp, sp, rp, zp, rows, channels, alpha,
                                leaky != 0, st);
  }
  return dispatch_residual<1>(yp, ld, bp, sp, rp, zp, rows, channels, alpha,
                              leaky != 0, st);
}

const char* conv_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
