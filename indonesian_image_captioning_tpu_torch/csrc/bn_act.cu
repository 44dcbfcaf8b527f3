// The ResNet's eval-mode pass after each convolution: BatchNorm with the
// running statistics, an optional shortcut, and ReLU, in one pass over the
// convolution's channels_last output.
//
//   y = relu(bn(x) + shortcut),  bn(x) = (x - mean) * (rsqrt(var + eps) *
//                                         scale) + bias
//
// where the shortcut is nothing (conv1, conv2, the stem), the block's input
// r (conv3 of a plain block), or the downsample convolution's raw output d
// under its own BatchNorm (conv3 of a downsampling block, whose shortcut
// BatchNorm so gets no pass of its own).
//
// It rounds where the JAX package's eval BatchNorm (models/resnet.py _bn)
// and the port's eager composition round: each operation in the promoted
// type of the activations and the statistics (float32 if either is, else
// bfloat16), the coefficient rsqrt(var + eps) * scale in the statistics'
// type, bn(x) to the activations' type, then the shortcut's add in that
// type.  The arithmetic is float32 with a rounding through bf16 after each
// step (rt<>), so at bf16 it gives the composition's values bit for bit
// (XLA on the CPU rounds the same way: the JAX serving tests hold the
// port's bf16 captions to JAX's), and rounding once instead would move
// them.
//
// Replaces no kernel of the JAX package: there XLA fuses the eval-mode
// BatchNorm, residual add and ReLU into one pass itself.  The port's eager
// composition (models/resnet.py _bn, relu, the add) ran them as five to
// eight full-size passes.
//
// What bounds it: bytes.  Each element of x (and of r or d) is read once and
// y written once, against a few flops: at one scn.images batch (256 images
// of 256 px, two ResNet-152s, 302 launches) about 74 GB, 22 ms at 3.35 TB/s.
//
// What the design does about it:
//   - channels_last storage, so a pixel's C channels are contiguous: a
//     thread moves 8 channels of a pixel as one 16-byte load and store at
//     bf16 (two at float32).  C is a multiple of 8, so a vector never
//     crosses a pixel.
//   - a grid-stride loop whose stride (blocks x 256 threads) is a multiple
//     of the C / 8 channel groups, so a thread's 8 channels stay the same
//     from pixel to pixel: it reads its channels' statistics once (through
//     L1) and keeps the per-channel coefficients in registers.
//   - as many blocks as the SMs hold at once (the occupancy query), no
//     more, and kUnroll vectors' loads in flight per thread.
//   - in place: y may be x.  The port's inference path writes over the
//     convolution output; each element is read and then written by the same
//     thread, so nothing else reads a value after it was overwritten.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace iic {

constexpr int kBnThreads = 256;
constexpr int kUnroll = 4;
enum BnMode { kPlain = 0, kResidual = 1, kDownsample = 2 };

struct BnActArgs {
  void* y;              // (pixels, C) output, may be x
  const void* x;        // (pixels, C) the convolution's output
  const void* r;        // the block's input (kResidual) or d (kDownsample)
  const void* vec[8];   // mean, var, scale, bias of x's BatchNorm, then d's
  long long nv;         // 8-channel vectors: pixels * C / 8
  int groups;           // C / 8
  float eps;
};

struct Raw8 {           // 8 values as stored: one or two 16-byte words
  uint4 w[2];
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, Raw8& v) {
  v.w[0] = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load8(const float* p, Raw8& v) {
  v.w[0] = reinterpret_cast<const uint4*>(p)[0];
  v.w[1] = reinterpret_cast<const uint4*>(p)[1];
}

__device__ __forceinline__ void unpack8(const Raw8& v, const __nv_bfloat16*,
                                        float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v.w[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack8(const Raw8& v, const float*,
                                        float (&f)[8]) {
  const float* s = reinterpret_cast<const float*>(&v.w[0]);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = s[i];
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = w;
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The type an operation of activations T and statistics TV rounds to.
template <typename T, typename TV> struct Promote { using type = float; };
template <> struct Promote<__nv_bfloat16, __nv_bfloat16> {
  using type = __nv_bfloat16;
};

// The 8 channels' mean, rsqrt(var + eps) * scale and bias, each step
// rounded to the statistics' type TV.
template <typename TV>
__device__ __forceinline__ void coefficients(const void* const* vec, int c0,
                                             float eps, float (&m)[8],
                                             float (&k)[8], float (&b)[8]) {
  const TV* mean = static_cast<const TV*>(vec[0]) + c0;
  const TV* var = static_cast<const TV*>(vec[1]) + c0;
  const TV* scale = static_cast<const TV*>(vec[2]) + c0;
  const TV* bias = static_cast<const TV*>(vec[3]) + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = to_f(mean[i]);
    const float v = rt<TV>(__fadd_rn(to_f(var[i]), eps));
    k[i] = rt<TV>(__fmul_rn(rt<TV>(rsqrtf(v)), to_f(scale[i])));
    b[i] = to_f(bias[i]);
  }
}

// bn(x) in the activations' type T, each step rounded to W.
template <typename T, typename W>
__device__ __forceinline__ float bn1(float x, float m, float k, float b) {
  return rt<T>(rt<W>(__fadd_rn(rt<W>(__fmul_rn(rt<W>(__fsub_rn(x, m)), k)),
                               b)));
}

template <typename T, typename TV, int kMode>
__global__ void __launch_bounds__(kBnThreads)
bn_act_kernel(BnActArgs a) {
  using W = typename Promote<T, TV>::type;
  const long long stride = (long long)gridDim.x * kBnThreads;
  const long long first = (long long)blockIdx.x * kBnThreads + threadIdx.x;
  const int c0 = (int)(first % a.groups) * 8;   // fixed: stride % groups == 0
  float m[8], k[8], b[8];
  coefficients<TV>(a.vec, c0, a.eps, m, k, b);
  float dm[8], dk[8], db[8];
  if (kMode == kDownsample)
    coefficients<TV>(a.vec + 4, c0, a.eps, dm, dk, db);

  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  T* y = static_cast<T*>(a.y);
  for (long long base = first; base < a.nv; base += stride * kUnroll) {
    Raw8 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * stride;
      if (j < a.nv) {
        load8(x + j * 8, xv[u]);
        if (kMode != kPlain) load8(r + j * 8, rv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * stride;
      if (j >= a.nv) break;
      float f[8];
      unpack8(xv[u], x, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = bn1<T, W>(f[i], m[i], k[i], b[i]);
      if (kMode != kPlain) {
        float g[8];
        unpack8(rv[u], r, g);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (kMode == kDownsample)
            g[i] = bn1<T, W>(g[i], dm[i], dk[i], db[i]);
          f[i] = rt<T>(__fadd_rn(f[i], g[i]));
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)         // relu; a NaN stays NaN
        f[i] = f[i] < 0.0f ? 0.0f : f[i];
      store8(y + j * 8, f);
    }
  }
}

static int gcd_int(int p, int q) {
  while (q != 0) {
    const int t = p % q;
    p = q;
    q = t;
  }
  return p;
}

template <typename T, typename TV, int kMode>
static int launch(const BnActArgs& a, cudaStream_t stream) {
  auto kernel = bn_act_kernel<T, TV, kMode>;
  static int per_sm = 0;      // resident blocks an SM, asked once
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kBnThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (a.nv + kBnThreads - 1) / kBnThreads;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  // the stride must hold whole rounds of channel groups
  const int q = a.groups / gcd_int(a.groups, kBnThreads);
  blocks = (blocks + q - 1) / q * q;
  kernel<<<(unsigned)blocks, kBnThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename TV>
static int launch_mode(int mode, const BnActArgs& a, cudaStream_t stream) {
  switch (mode) {
    case kPlain: return launch<T, TV, kPlain>(a, stream);
    case kResidual: return launch<T, TV, kResidual>(a, stream);
    case kDownsample: return launch<T, TV, kDownsample>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace iic

// dtype, vdtype: 0 float32, 1 bfloat16 (the activations', the statistics').
// mode: 0 BatchNorm + ReLU; 1 + r, then ReLU; 2 + r under its BatchNorm
// (vd: its mean, var, scale, bias), then ReLU.  y may be x.
extern "C" int iic_bn_act(int dtype, int vdtype, int mode, void* y,
                          const void* x, const void* r, const void* mean,
                          const void* var, const void* scale,
                          const void* bias, const void* dmean,
                          const void* dvar, const void* dscale,
                          const void* dbias, long long pixels, int C,
                          float eps, void* stream) {
  using namespace iic;
  if (C < 8 || C % 8 != 0 || pixels < 1) return (int)cudaErrorInvalidValue;
  BnActArgs a{y, x, r, {mean, var, scale, bias, dmean, dvar, dscale, dbias},
              pixels * (C / 8), C / 8, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && vdtype == kBF16)
    return launch_mode<__nv_bfloat16, __nv_bfloat16>(mode, a, s);
  if (dtype == kBF16 && vdtype == kF32)
    return launch_mode<__nv_bfloat16, float>(mode, a, s);
  if (dtype == kF32 && vdtype == kBF16)
    return launch_mode<float, __nv_bfloat16>(mode, a, s);
  if (dtype == kF32 && vdtype == kF32)
    return launch_mode<float, float>(mode, a, s);
  return (int)cudaErrorInvalidValue;
}
