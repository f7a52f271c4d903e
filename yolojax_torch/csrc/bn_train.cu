// Train-mode conv epilogue for Hopper (sm_90a): the batch statistics of BN
// and the backward of BN (or bias) + leaky + the cast to bf16.
//
// Replaces what XLA fuses around the train-mode epilogue of
// yolojax/nn/layers.py::apply_network (:397-420: jnp.mean and jnp.var of
// the f32 upcast, batch_norm, leaky, the cast) and around its VJP, which
// jax.grad generates in yolojax/train/step.py:302 (yolojax has no Pallas
// kernel for either). The forward's normalise + leaky + cast is
// conv_epilogue.cu with BN's (inv, shift) from these statistics; this file
// holds the rest, for y (rows, C) bf16 at row stride ldy, the gradient g of
// the epilogue's bf16 output (rows, C) at row stride ldg, and per-channel
// f32 vectors:
//
// (a) bn_sums: Σy, or, given the mean m, Σ(y - m)² with y - m in f32 (the
//     two passes of the batch statistics, two launches a BN conv);
// (b) grad_sums: Σdz and, for BN, Σdz·x̂, where
//       z  = y * inv + shift   (bias layer: y + shift), two roundings
//       dz = g * (z >= 0 ? 1 : alpha)        (linear layer: g)
//       x̂  = (y - m) * rstd;
// (c) grad_apply: dy = bf16(inv * ((dz - mdz) - x̂ * mdzx)), mdz and mdzx
//     the batch means of dz and dz·x̂ (bias layer: dy = bf16(dz)), written
//     row-major.
//
// Every elementwise step is a round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __float2bfloat16_rn), so nvcc contracts nothing:
// z is the forward's z bit for bit (the leaky mask sends -0.0 and NaN
// where torch.where does, v >= 0.0f), and (c) equals its plain version
// (nn/layers.py::epilogue_grad_apply_torch) bit for bit given the same
// vectors. The sums (a) and (b) take another order than torch's and are
// held to a float64 sum instead.
//
// What bounds it on this card: bytes. (a) reads 2 B a value, (b) 4 B, (c)
// reads 4 B and writes 2 B, with a few f32 operations a value (far below
// the card's ~20 a byte). The design is the simple one.
//
// The reductions are deterministic: no float atomics. A grid of channel
// tiles x row chunks; a block of 256 threads covers up to 32 channel
// vectors of a tile (8 channels = 16 B a thread where C, the row strides
// and the pointers allow, else 1) and 256 / units row lanes, so
// consecutive threads read consecutive channels of a row and a warp reads
// whole rows when C is narrow (conv 0: C = 32, 64 lanes). Each thread sums
// its lane's rows of the chunk in f32 registers (the wrapper sizes the
// chunks so that no thread sums more than 256 values); the block then sums
// its lanes in a fixed order through shared memory and writes one f32
// partial a channel and chunk, and a second kernel sums each channel's
// partials in float64 in a fixed order. The bound on the error against a
// float64 sum of the same f32 terms is (256 + lanes) * 2^-24 of the sum
// of their magnitudes. The elementwise pass (c) is conv_epilogue.cu's
// grid-stride loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxUnits = 32;  // channel vectors a reduction block covers
constexpr int kBlocksPerSm = 8;

enum Mode { kSum = 0, kCentred = 1, kGradBias = 2, kGradBn = 3 };

__device__ __forceinline__ float bf(unsigned short h) {
  return __bfloat162float(__ushort_as_bfloat16(h));
}

union Pack8 {
  uint4 vec;
  unsigned short h[8];
};

// kVec consecutive bf16 values at p: one 16-byte load or one 2-byte load.
template <int kVec>
__device__ __forceinline__ void load_row(const unsigned short* p, float* out) {
  if constexpr (kVec == 8) {
    Pack8 in;
    in.vec = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = bf(in.h[i]);
  } else {
    out[0] = bf(*p);
  }
}

template <int kVec>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float* out) {
  if constexpr (kVec == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
    out[0] = __ldg(p);
  }
}

// dz for one value: the forward's z, then leaky's slope.
template <bool kBn, bool kLeaky>
__device__ __forceinline__ float grad_z(float g, float v, float inv,
                                        float shift, float alpha) {
  if (!kLeaky) return g;
  const float z = kBn ? __fadd_rn(__fmul_rn(v, inv), shift) : __fadd_rn(v, shift);
  return z >= 0.0f ? g : __fmul_rn(alpha, g);
}

// Stage 1 of (a) and (b): partial[acc][c][chunk], the sum of this chunk's
// rows of channel c.
template <int kVec, int kMode, bool kLeaky>
__global__ void __launch_bounds__(kThreads)
channel_sums_kernel(const unsigned short* __restrict__ y, int64_t ldy,
                    const unsigned short* __restrict__ g, int64_t ldg,
                    const float* __restrict__ inv, const float* __restrict__ shift,
                    const float* __restrict__ m, const float* __restrict__ rstd,
                    float alpha, int64_t rows, int channels,
                    int64_t chunk_rows, float* __restrict__ partial) {
  constexpr int kAcc = kMode == kGradBn ? 2 : 1;
  constexpr bool kBn = kMode == kGradBn;
  __shared__ float red[kAcc * kThreads * kVec];

  const int units = channels / kVec;
  const int tile_units = units < kMaxUnits ? units : kMaxUnits;
  const int lanes = kThreads / tile_units;
  const int tw = tile_units * kVec;  // channels a tile
  const int t = threadIdx.x;
  const int lane = t / tile_units;
  const int unit = blockIdx.x * tile_units + t % tile_units;
  const bool active = lane < lanes && unit < units;
  const int c0 = unit * kVec;

  float acc[kAcc][kVec];
#pragma unroll
  for (int a = 0; a < kAcc; ++a)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[a][i] = 0.0f;

  if (active) {
    float pm[kVec], pinv[kVec], pshift[kVec], prstd[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) pm[i] = pinv[i] = pshift[i] = prstd[i] = 0.0f;
    if (kMode == kCentred || kMode == kGradBn) load_vec<kVec>(m + c0, pm);
    if (kMode == kGradBn) {
      load_vec<kVec>(inv + c0, pinv);
      load_vec<kVec>(rstd + c0, prstd);
    }
    if ((kMode == kGradBias || kMode == kGradBn) && kLeaky) {
      load_vec<kVec>(shift + c0, pshift);
    }
    const int64_t r0 = static_cast<int64_t>(blockIdx.y) * chunk_rows;
    const int64_t r1 = r0 + chunk_rows < rows ? r0 + chunk_rows : rows;
    // a linear bias layer's dz is g: its y is not read
    constexpr bool kReadY = kMode != kGradBias || kLeaky;
    for (int64_t row = r0 + lane; row < r1; row += lanes) {
      float v[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = 0.0f;
      if (kReadY) load_row<kVec>(y + row * ldy + c0, v);
      if constexpr (kMode == kSum) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[0][i] = __fadd_rn(acc[0][i], v[i]);
      } else if constexpr (kMode == kCentred) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = __fsub_rn(v[i], pm[i]);
          acc[0][i] = __fadd_rn(acc[0][i], __fmul_rn(d, d));
        }
      } else {
        float gv[kVec];
        load_row<kVec>(g + row * ldg + c0, gv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float dz = grad_z<kBn, kLeaky>(gv[i], v[i], pinv[i], pshift[i], alpha);
          acc[0][i] = __fadd_rn(acc[0][i], dz);
          if constexpr (kBn) {
            const float xh = __fmul_rn(__fsub_rn(v[i], pm[i]), prstd[i]);
            acc[kAcc - 1][i] = __fadd_rn(acc[kAcc - 1][i], __fmul_rn(dz, xh));
          }
        }
      }
    }
  }
  if (lane < lanes) {
    const int col = (t % tile_units) * kVec;
#pragma unroll
    for (int a = 0; a < kAcc; ++a)
#pragma unroll
      for (int i = 0; i < kVec; ++i) red[(a * lanes + lane) * tw + col + i] = acc[a][i];
  }
  __syncthreads();
  const int64_t chunks = gridDim.y;
  for (int j = t; j < kAcc * tw; j += kThreads) {
    const int a = j / tw;
    const int col = j - a * tw;
    const int c = blockIdx.x * tw + col;
    if (c >= channels) continue;
    float s = 0.0f;
    for (int l = 0; l < lanes; ++l) s = __fadd_rn(s, red[(a * lanes + l) * tw + col]);
    partial[(static_cast<int64_t>(a) * channels + c) * chunks + blockIdx.y] = s;
  }
}

// Stage 2: out[j] = the float64 sum of partial[j][0 .. chunks), one block a
// (acc, channel) pair, in a fixed order. kMode only names the kernel after
// its stage 1, so a profile tells (a)'s from (b)'s.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ partial, int chunks,
                float* __restrict__ out) {
  __shared__ double red[kThreads];
  const float* p = partial + static_cast<int64_t>(blockIdx.x) * chunks;
  double s = 0.0;
  for (int k = threadIdx.x; k < chunks; k += kThreads) s += static_cast<double>(p[k]);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<float>(red[0]);
}

template <int kVec, int kMode, bool kLeaky>
cudaError_t sums(const unsigned short* y, int64_t ldy, const unsigned short* g,
                 int64_t ldg, const float* inv, const float* shift,
                 const float* m, const float* rstd, float alpha, int64_t rows,
                 int channels, int64_t chunk_rows, int chunks, float* partial,
                 float* out, cudaStream_t stream) {
  constexpr int kAcc = kMode == kGradBn ? 2 : 1;
  const int units = channels / kVec;
  const int tile_units = units < kMaxUnits ? units : kMaxUnits;
  const dim3 grid((units + tile_units - 1) / tile_units, chunks);
  channel_sums_kernel<kVec, kMode, kLeaky><<<grid, kThreads, 0, stream>>>(
      y, ldy, g, ldg, inv, shift, m, rstd, alpha, rows, channels, chunk_rows,
      partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<kMode><<<kAcc * channels, kThreads, 0, stream>>>(partial, chunks, out);
  return cudaGetLastError();
}

template <int kMode, bool kLeaky>
cudaError_t sums_vec(int vec, const unsigned short* y, int64_t ldy,
                     const unsigned short* g, int64_t ldg, const float* inv,
                     const float* shift, const float* m, const float* rstd,
                     float alpha, int64_t rows, int channels,
                     int64_t chunk_rows, int chunks, float* partial, float* out,
                     cudaStream_t stream) {
  if (vec == 8) {
    return sums<8, kMode, kLeaky>(y, ldy, g, ldg, inv, shift, m, rstd, alpha, rows,
                                  channels, chunk_rows, chunks, partial, out, stream);
  }
  return sums<1, kMode, kLeaky>(y, ldy, g, ldg, inv, shift, m, rstd, alpha, rows,
                                channels, chunk_rows, chunks, partial, out, stream);
}

// (c): grid-stride over the output, kVec channels a thread.
template <int kVec, bool kBn, bool kLeaky>
__global__ void __launch_bounds__(kThreads)
grad_apply_kernel(const unsigned short* __restrict__ g, int64_t ldg,
                  const unsigned short* __restrict__ y, int64_t ldy,
                  const float* __restrict__ inv, const float* __restrict__ shift,
                  const float* __restrict__ m, const float* __restrict__ rstd,
                  const float* __restrict__ mdz, const float* __restrict__ mdzx,
                  float alpha, int64_t rows, int channels,
                  unsigned short* __restrict__ dy) {
  const int units = channels / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t row = first / units;
  int u = static_cast<int>(first - row * units);
  const int64_t row_step = stride / units;
  const int u_step = static_cast<int>(stride - row_step * units);
  while (row < rows) {
    const int c = u * kVec;
    float gv[kVec], v[kVec], pshift[kVec];
    float pinv[kVec], pm[kVec], prstd[kVec], pmdz[kVec], pmdzx[kVec];
    load_row<kVec>(g + row * ldg + c, gv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      v[i] = pshift[i] = pinv[i] = pm[i] = prstd[i] = pmdz[i] = pmdzx[i] = 0.0f;
    }
    if (kLeaky || kBn) load_row<kVec>(y + row * ldy + c, v);
    if (kLeaky) load_vec<kVec>(shift + c, pshift);
    if (kBn) {
      load_vec<kVec>(inv + c, pinv);
      load_vec<kVec>(m + c, pm);
      load_vec<kVec>(rstd + c, prstd);
      load_vec<kVec>(mdz + c, pmdz);
      load_vec<kVec>(mdzx + c, pmdzx);
    }
    unsigned short out[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float d = grad_z<kBn, kLeaky>(gv[i], v[i], pinv[i], pshift[i], alpha);
      if (kBn) {
        const float xh = __fmul_rn(__fsub_rn(v[i], pm[i]), prstd[i]);
        d = __fmul_rn(pinv[i], __fsub_rn(__fsub_rn(d, pmdz[i]), __fmul_rn(xh, pmdzx[i])));
      }
      out[i] = __bfloat16_as_ushort(__float2bfloat16_rn(d));
    }
    unsigned short* dst = dy + row * channels + c;
    if constexpr (kVec == 8) {
      Pack8 p;
#pragma unroll
      for (int i = 0; i < 8; ++i) p.h[i] = out[i];
      *reinterpret_cast<uint4*>(dst) = p.vec;
    } else {
      *dst = out[0];
    }
    row += row_step;
    u += u_step;
    if (u >= units) {
      u -= units;
      ++row;
    }
  }
}

template <int kVec, bool kBn, bool kLeaky>
cudaError_t apply_grad(const unsigned short* g, int64_t ldg, const unsigned short* y,
                  int64_t ldy, const float* inv, const float* shift,
                  const float* m, const float* rstd, const float* mdz,
                  const float* mdzx, float alpha, int64_t rows, int channels,
                  unsigned short* dy, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t total = rows * (channels / kVec);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  grad_apply_kernel<kVec, kBn, kLeaky><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      g, ldg, y, ldy, inv, shift, m, rstd, mdz, mdzx, alpha, rows, channels, dy);
  return cudaGetLastError();
}

template <int kVec>
cudaError_t apply_mode(bool bn, bool leaky, const unsigned short* g, int64_t ldg,
                       const unsigned short* y, int64_t ldy, const float* inv,
                       const float* shift, const float* m, const float* rstd,
                       const float* mdz, const float* mdzx, float alpha,
                       int64_t rows, int channels, unsigned short* dy,
                       cudaStream_t stream) {
  if (bn) {
    return leaky ? apply_grad<kVec, true, true>(g, ldg, y, ldy, inv, shift, m, rstd, mdz, mdzx, alpha, rows, channels, dy, stream)
                 : apply_grad<kVec, true, false>(g, ldg, y, ldy, inv, shift, m, rstd, mdz, mdzx, alpha, rows, channels, dy, stream);
  }
  return leaky ? apply_grad<kVec, false, true>(g, ldg, y, ldy, inv, shift, m, rstd, mdz, mdzx, alpha, rows, channels, dy, stream)
               : apply_grad<kVec, false, false>(g, ldg, y, ldy, inv, shift, m, rstd, mdz, mdzx, alpha, rows, channels, dy, stream);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The reductions' own checks: the geometry the wrapper chose fits the grid
// and covers every row, and the 8-channel path is asked for only where it
// may run.
bool sums_args_ok(int64_t rows, int channels, int64_t ldy, int64_t ldg,
                  int64_t chunk_rows, int chunks, int vec, const void* y,
                  const void* g, const void* const* vectors, int n_vectors) {
  if (ldy < channels || (g != nullptr && ldg < channels)) return false;
  if (chunks <= 0 || chunks > 65535 || chunk_rows <= 0) return false;
  if (static_cast<int64_t>(chunks) * chunk_rows < rows) return false;
  if ((static_cast<int64_t>(chunks) - 1) * chunk_rows >= rows) return false;
  if (vec == 1) return true;
  if (vec != 8 || channels % 8 != 0 || ldy % 8 != 0) return false;
  if (g != nullptr && ldg % 8 != 0) return false;
  if (!aligned16(y) || !aligned16(g)) return false;
  for (int i = 0; i < n_vectors; ++i) {
    if (!aligned16(vectors[i])) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// (a): out (C) f32 = Σ over rows of y, or of (y - m)² when m is not NULL.
// partial holds chunks * C floats. vec (8 or 1), chunk_rows and chunks are
// the wrapper's geometry (nn/cuda_bn_train.py::sums_geometry). Returns a
// cudaError_t (0 on success); the launches are asynchronous on stream.
int bn_sums_launch(const void* y, long long ldy, const void* m, long long rows,
                   int channels, long long chunk_rows, int chunks, int vec,
                   void* partial, void* out, void* stream) {
  if (rows <= 0 || channels <= 0) return cudaErrorInvalidValue;
  const void* vectors[] = {m};
  if (!sums_args_ok(rows, channels, ldy, 0, chunk_rows, chunks, vec, y, nullptr,
                    vectors, 1)) {
    return cudaErrorInvalidValue;
  }
  const auto* yp = static_cast<const unsigned short*>(y);
  const auto* mp = static_cast<const float*>(m);
  auto* pp = static_cast<float*>(partial);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (m == nullptr) {
    return sums_vec<kSum, false>(vec, yp, ldy, nullptr, 0, nullptr, nullptr, nullptr,
                                 nullptr, 0.0f, rows, channels, chunk_rows, chunks,
                                 pp, op, st);
  }
  return sums_vec<kCentred, false>(vec, yp, ldy, nullptr, 0, nullptr, nullptr, mp,
                                   nullptr, 0.0f, rows, channels, chunk_rows, chunks,
                                   pp, op, st);
}

// (b): out (2, C) f32 = (Σdz, Σdz·x̂) when inv is not NULL (m and rstd
// then given too), else (1, C) = (Σdz,) with shift the bias. partial holds
// rows_of_out * chunks * C floats.
int grad_sums_launch(const void* g, long long ldg, const void* y, long long ldy,
                     const void* inv, const void* shift, const void* m,
                     const void* rstd, float alpha, int leaky, long long rows,
                     int channels, long long chunk_rows, int chunks, int vec,
                     void* partial, void* out, void* stream) {
  if (rows <= 0 || channels <= 0) return cudaErrorInvalidValue;
  if (inv != nullptr && (m == nullptr || rstd == nullptr)) return cudaErrorInvalidValue;
  if (leaky && shift == nullptr) return cudaErrorInvalidValue;
  const void* vectors[] = {inv, shift, m, rstd};
  if (!sums_args_ok(rows, channels, ldy, ldg, chunk_rows, chunks, vec, y, g,
                    vectors, 4)) {
    return cudaErrorInvalidValue;
  }
  const auto* gp = static_cast<const unsigned short*>(g);
  const auto* yp = static_cast<const unsigned short*>(y);
  const auto* ip = static_cast<const float*>(inv);
  const auto* sp = static_cast<const float*>(shift);
  const auto* mp = static_cast<const float*>(m);
  const auto* rp = static_cast<const float*>(rstd);
  auto* pp = static_cast<float*>(partial);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (inv != nullptr) {
    return leaky ? sums_vec<kGradBn, true>(vec, yp, ldy, gp, ldg, ip, sp, mp, rp, alpha,
                                           rows, channels, chunk_rows, chunks, pp, op, st)
                 : sums_vec<kGradBn, false>(vec, yp, ldy, gp, ldg, ip, sp, mp, rp, alpha,
                                            rows, channels, chunk_rows, chunks, pp, op, st);
  }
  return leaky ? sums_vec<kGradBias, true>(vec, yp, ldy, gp, ldg, ip, sp, mp, rp, alpha,
                                           rows, channels, chunk_rows, chunks, pp, op, st)
               : sums_vec<kGradBias, false>(vec, yp, ldy, gp, ldg, ip, sp, mp, rp, alpha,
                                            rows, channels, chunk_rows, chunks, pp, op, st);
}

// (c): dy (rows, C) bf16 row-major. BN mode when inv is not NULL (m, rstd,
// mdz and mdzx then given too); shift is needed with leaky. The 8-channel
// path runs when C and both row strides are multiples of 8 and every
// pointer is 16-byte aligned.
int grad_apply_launch(const void* g, long long ldg, const void* y, long long ldy,
                      const void* inv, const void* shift, const void* m,
                      const void* rstd, const void* mdz, const void* mdzx,
                      float alpha, int leaky, long long rows, int channels,
                      void* dy, void* stream) {
  if (rows <= 0 || channels <= 0) return cudaSuccess;
  if (ldg < channels || ldy < channels) return cudaErrorInvalidValue;
  const bool bn = inv != nullptr;
  if (bn && (m == nullptr || rstd == nullptr || mdz == nullptr || mdzx == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (leaky && shift == nullptr) return cudaErrorInvalidValue;
  const auto* gp = static_cast<const unsigned short*>(g);
  const auto* yp = static_cast<const unsigned short*>(y);
  const auto* ip = static_cast<const float*>(inv);
  const auto* sp = static_cast<const float*>(shift);
  const auto* mp = static_cast<const float*>(m);
  const auto* rp = static_cast<const float*>(rstd);
  const auto* dp = static_cast<const float*>(mdz);
  const auto* xp = static_cast<const float*>(mdzx);
  auto* out = static_cast<unsigned short*>(dy);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec8 = channels % 8 == 0 && ldg % 8 == 0 && ldy % 8 == 0 &&
                    aligned16(g) && aligned16(y) && aligned16(dy) &&
                    aligned16(inv) && aligned16(shift) && aligned16(m) &&
                    aligned16(rstd) && aligned16(mdz) && aligned16(mdzx);
  if (vec8) {
    return apply_mode<8>(bn, leaky != 0, gp, ldg, yp, ldy, ip, sp, mp, rp, dp, xp,
                         alpha, rows, channels, out, st);
  }
  return apply_mode<1>(bn, leaky != 0, gp, ldg, yp, ldy, ip, sp, mp, rp, dp, xp,
                       alpha, rows, channels, out, st);
}

const char* bn_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
