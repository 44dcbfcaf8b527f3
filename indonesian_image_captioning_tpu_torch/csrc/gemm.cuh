// The float32 FFMA GEMM of the train scan (train.cu), the fused SCN cell
// (scn.cu) and the vocab head (fc_topk.cu), with its fused epilogues.
// The decode step chain (step.cu, span.cu) runs the same contract on the
// tensor cores (mma.cuh, which shares GemmArgs, the epilogues and the
// split-K reduce defined here); step.cu's iic_gemm_ffma keeps this GEMM
// callable as the yardstick the card tests and chip_smoke.py hold that
// one against.
//
//   C[z] = epilogue(A1[z] @ W1[z] + A2[z] @ W2[z] + A3[z] @ W3[z])
//
// Up to three sources accumulate into one sum (a product over a
// concatenated input); z = blockIdx.z offsets the columns of A (za), the
// elements of W (zw), the columns of C, C2, aux, aux2 and acc (zc) and the
// elements of the biases (zb).  W is stored (K, N) row-major, or (N, K)
// row-major when wt[s] is set: the backward's products against transposed
// weights (x @ W^T) read W in place instead of a transposed copy.
//
// The GEMM tiles 64 x 64 outputs per block (32 x 128 when M <= 32, so a
// 32-row product computes no padding rows) with 16-deep float32 tiles in
// shared memory (a weight column is read once per row block); each of the
// 256 threads keeps a 4 x 4 block of sums, and loads the next tile into
// registers while it multiplies the current one.  float32 FFMA, no tensor
// cores.
//
// Split-K: a product with few output tiles (the train scan's 32-row
// per-step products fill 8-40 blocks of 132 SMs) runs with ksplit blocks
// per output tile, each over one slice of the concatenated K.  Each block
// writes its partial sums to the float32 scratch `part`; a second launch
// adds the ksplit partials of each output in slice order and applies the
// epilogue, so the result does not depend on the order blocks ran in.
// ksplit is picked for about two blocks per SM, within part_cap floats;
// with no scratch (part == nullptr) the product runs unsplit.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace iic {

constexpr int kBK = 16, kGemmThreads = 256;

enum Epilogue {
  kEpiBias = 0,        // rt(rt(acc) + b1), as dot(...).astype(dt) + b
  kEpiPre = 1,         // acc + b1 + b2 + aux in float32 (pre-activations)
  kEpiSigmoidMul = 2,  // rt(rt(sigmoid(rt(rt(acc) + b1))) * aux)
  kEpiMul = 3,         // rt(rt(acc) * aux)
  // train.cu:
  kEpiAddMul = 4,      // v = rt(rt(acc) + aux); C2 = rt(v * aux2[row / div])
  kEpiGate = 5,        // v = sigmoid(acc + b1) (float32); C2 = rt(rt(v) * aux)
  kEpiRawMul = 6,      // v = acc (float32); C2 = rt(acc * aux2[row / div])
  kEpiFacBwd = 7,      // acc_out += acc * aux2; v = rt(acc * aux)
  kEpiGateBwd = 8,     // g = aux2, C2 = rt(acc * g); v = rt(acc * aux * g (1 - g))
  // scn.cu:
  kEpiF32Mul = 9,      // v = acc * aux in float32, not rounded
};

struct GemmArgs {
  const void* a[3];
  const void* w[3];
  const void* w_lo[3];  // mma.cuh: a float32 W pre-split, its lo parts
  int k[3];
  int wt[3];
  long long lda[3];
  long long ldw[3];
  const void* bias1;   // T, (N,) per z
  const void* bias2;
  const void* aux;     // T, (M, ldaux)
  long long ldaux;
  const void* aux2;    // T or float32 (aux2_f32), row gm / aux2_div
  long long ldaux2;
  int aux2_div;
  int aux2_f32;
  void* c;             // T or float32 (c_f32)
  long long ldc;
  int c_f32;
  void* c2;            // T
  long long ldc2;
  float* acc;          // float32 accumulator, read and written
  long long ldacc;
  int M, N, epi;
  long long za, zw, zc, zb;
  int nz;              // z-slices (set by launch_gemm)
  int ksplit;          // K slices per output tile (set by launch_gemm)
  int kchunk;          // the concatenated K of one slice (set by launch_gemm)
  float* part;         // float32 scratch for split-K partials, or null
  long long part_cap;  // its size in floats
};

constexpr int kSms = 132;

// What the epilogue reads for one output (gm, gn) of slice z besides its
// sum -- bias1[gn], bias2[gn], aux[gm, gn] and aux2[gm / aux2_div, col],
// each where epilogue e reads it, else 0 -- by read-only loads
// (ld.global.nc), which the compiler may move past the epilogue's
// stores, so that a batch of them is in flight at once.
struct GemmIn {
  float b1, b2, aux, aux2;
};

// Whether epilogue e reads bias1 (bias2: kEpiPre alone) and aux.
__device__ __forceinline__ bool epi_reads_bias1(int e) {
  return e == kEpiBias || e == kEpiPre || e == kEpiSigmoidMul ||
         e == kEpiGate;
}
__device__ __forceinline__ bool epi_reads_aux(int e) {
  return e != kEpiBias && e != kEpiRawMul;
}

template <typename T>
__device__ __forceinline__ GemmIn gemm_load(const GemmArgs& g, int e, int z,
                                            int gm, int gn) {
  GemmIn in = {0.0f, 0.0f, 0.0f, 0.0f};
  if (g.bias1 && epi_reads_bias1(e))
    in.b1 = to_f(__ldg((const T*)g.bias1 + z * g.zb + gn));
  if (g.bias2 && e == kEpiPre)
    in.b2 = to_f(__ldg((const T*)g.bias2 + z * g.zb + gn));
  if (g.aux && epi_reads_aux(e))
    in.aux = to_f(__ldg((const T*)g.aux + z * g.zc + gm * g.ldaux + gn));
  if (g.aux2 != nullptr) {
    const long long ai = (gm / g.aux2_div) * g.ldaux2 + z * g.zc + gn;
    in.aux2 = g.aux2_f32 ? __ldg((const float*)g.aux2 + ai)
                         : to_f(__ldg((const T*)g.aux2 + ai));
  }
  return in;
}

// Epilogue E's value of one output (gm, gn) of slice z from its float32
// sum v and what it reads (gemm_load), and its second output v2 where the
// epilogue has one (kEpiFacBwd adds into acc here).
template <typename T, int E>
__device__ __forceinline__ float epi_apply(const GemmArgs& g, int z, int gm,
                                           int gn, float v, const GemmIn& in,
                                           float& v2) {
  const float aux2v = in.aux2;
  v2 = 0.0f;    // the second output, where the epilogue has one
  if constexpr (E == kEpiBias) {
    v = rt<T>(v);
    if (g.bias1) v = rt<T>(v + in.b1);
  } else if constexpr (E == kEpiPre) {
    if (g.bias1) v += in.b1;
    if (g.bias2) v += in.b2;
    if (g.aux) v += in.aux;
  } else if constexpr (E == kEpiSigmoidMul) {
    float x = rt<T>(v);
    if (g.bias1) x = rt<T>(x + in.b1);
    const float gate = rt<T>(sigmoidf_(x));
    v = rt<T>(gate * in.aux);
  } else if constexpr (E == kEpiMul) {
    v = rt<T>(rt<T>(v) * in.aux);
  } else if constexpr (E == kEpiAddMul) {
    v = rt<T>(rt<T>(v) + in.aux);
    v2 = v * aux2v;
  } else if constexpr (E == kEpiGate) {
    v = sigmoidf_(v + (g.bias1 ? in.b1 : 0.0f));
    v2 = rt<T>(v) * in.aux;
  } else if constexpr (E == kEpiRawMul) {
    v2 = v * aux2v;
  } else if constexpr (E == kEpiFacBwd) {
    g.acc[gm * g.ldacc + z * g.zc + gn] += v * aux2v;
    v = v * in.aux;
  } else if constexpr (E == kEpiGateBwd) {
    const float d_gate = v * in.aux;
    v2 = v * aux2v;
    v = d_gate * aux2v * (1.0f - aux2v);
  } else if constexpr (E == kEpiF32Mul) {
    v = v * in.aux;
  }
  return v;
}

// The runtime epilogue code e as epi_apply's compile-time one.
template <typename T>
__device__ __forceinline__ float epi_value(const GemmArgs& g, int z, int gm,
                                           int gn, float v, const GemmIn& in,
                                           float& v2) {
  switch (g.epi) {
    case kEpiBias: return epi_apply<T, kEpiBias>(g, z, gm, gn, v, in, v2);
    case kEpiPre: return epi_apply<T, kEpiPre>(g, z, gm, gn, v, in, v2);
    case kEpiSigmoidMul:
      return epi_apply<T, kEpiSigmoidMul>(g, z, gm, gn, v, in, v2);
    case kEpiMul: return epi_apply<T, kEpiMul>(g, z, gm, gn, v, in, v2);
    case kEpiAddMul: return epi_apply<T, kEpiAddMul>(g, z, gm, gn, v, in, v2);
    case kEpiGate: return epi_apply<T, kEpiGate>(g, z, gm, gn, v, in, v2);
    case kEpiRawMul: return epi_apply<T, kEpiRawMul>(g, z, gm, gn, v, in, v2);
    case kEpiFacBwd: return epi_apply<T, kEpiFacBwd>(g, z, gm, gn, v, in, v2);
    case kEpiGateBwd:
      return epi_apply<T, kEpiGateBwd>(g, z, gm, gn, v, in, v2);
    default: return epi_apply<T, kEpiF32Mul>(g, z, gm, gn, v, in, v2);
  }
}

template <typename T>
__device__ __forceinline__ void epilogue(const GemmArgs& g, int z, int gm,
                                         int gn, float v) {
  float v2;
  v = epi_value<T>(g, z, gm, gn, v, gemm_load<T>(g, g.epi, z, gm, gn), v2);
  const long long ci = gm * g.ldc + z * g.zc + gn;
  if (g.c_f32)
    ((float*)g.c)[ci] = v;
  else
    ((T*)g.c)[ci] = from_f<T>(v);
  if (g.c2 != nullptr)
    ((T*)g.c2)[gm * g.ldc2 + z * g.zc + gn] = from_f<T>(v2);
}

// The n <= 4 values v at p[0 .. n): one 16-byte store where p is aligned
// for it and n = 4, else the widest stores its alignment allows.
__device__ __forceinline__ void store4(float* p, const float* v, int n) {
  if (n == 4 && (uintptr_t)p % 16 == 0) {
    *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
  } else if (n == 4 && (uintptr_t)p % 8 == 0) {
    *(float2*)p = make_float2(v[0], v[1]);
    *(float2*)(p + 2) = make_float2(v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n) p[k] = v[k];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v,
                                       int n) {
  if (n == 4 && (uintptr_t)p % 4 == 0) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    if ((uintptr_t)p % 8 == 0) {
      *(uint2*)p = make_uint2(*(const uint32_t*)&a, *(const uint32_t*)&b);
    } else {
      *(__nv_bfloat162*)p = a;
      *(__nv_bfloat162*)(p + 2) = b;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n) p[k] = __float2bfloat16(v[k]);
  }
}

// Epilogue E on the n <= 4 neighbouring outputs (gm, gn ..) from their
// float32 sums v and what they read (in; gemm_load's values): epilogue<T>'s
// values, stored as store4 stores them.
template <typename T, int E>
__device__ __forceinline__ void epilogue4(const GemmArgs& g, int z, int gm,
                                          int gn, const float* v,
                                          const GemmIn* in, int n) {
  float o[4], o2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = epi_apply<T, E>(g, z, gm, gn + k, v[k], in[k], o2[k]);
  const long long ci = gm * g.ldc + z * g.zc + gn;
  if (g.c_f32)
    store4((float*)g.c + ci, o, n);
  else
    store4((T*)g.c + ci, o, n);
  if (g.c2 != nullptr)
    store4((T*)g.c2 + gm * g.ldc2 + z * g.zc + gn, o2, n);
}

template <typename T, int BM, int BN, typename TA>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  static_assert((BM / 4) * (BN / 4) == kGemmThreads, "4 x 4 per thread");
  __shared__ float As[kBK][BM + 1];
  __shared__ float Ws[kBK][BN + 1];
  const int z = blockIdx.z / g.ksplit;
  const int ks = blockIdx.z % g.ksplit;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);  // 4 output columns each
  const int ty = tid / (BN / 4);  // 4 output rows each
  constexpr int kLoadsA = (BM * kBK) / kGemmThreads;
  constexpr int kLoadsW = (kBK * BN) / kGemmThreads;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // this block's slice [lo, hi) of the sources' concatenated K
  const int lo = ks * g.kchunk;
  const int hi = lo + g.kchunk;
  int off = 0;
  for (int s = 0; s < 3; ++s) {
    if (g.a[s] == nullptr) continue;
    const int k_lo = max(lo - off, 0);
    const int k_hi = min(hi - off, g.k[s]);
    off += g.k[s];
    if (k_lo >= k_hi) continue;
    const TA* A = (const TA*)g.a[s] + z * g.za;
    const T* W = (const T*)g.w[s] + z * g.zw;
    const int wt = g.wt[s];
    const long long lda = g.lda[s];
    const long long ldw = g.ldw[s];
    // the next tile, in the storage type until it is stored to shared
    // memory (a conversion at the load would wait for the load)
    TA ra[kLoadsA];
    T rw[kLoadsW];
    const TA zero_a = from_f<TA>(0.0f);
    const T zero = from_f<T>(0.0f);
    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < kLoadsA; ++i) {
        const int idx = tid + i * kGemmThreads;
        const int gm = m0 + idx / kBK, gk = k0 + idx % kBK;
        ra[i] = (gm < g.M && gk < k_hi) ? A[gm * lda + gk] : zero_a;
      }
#pragma unroll
      for (int i = 0; i < kLoadsW; ++i) {
        const int idx = tid + i * kGemmThreads;
        if (!wt) {        // W (K, N): neighbouring threads, neighbouring n
          const int wk = k0 + idx / BN, wn = n0 + idx % BN;
          rw[i] = (wk < k_hi && wn < g.N) ? W[wk * ldw + wn] : zero;
        } else {          // W (N, K): neighbouring threads, neighbouring k
          const int wk = k0 + idx % kBK, wn = n0 + idx / kBK;
          rw[i] = (wk < k_hi && wn < g.N) ? W[wn * ldw + wk] : zero;
        }
      }
    };
    load(k_lo);
    for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
#pragma unroll
      for (int i = 0; i < kLoadsA; ++i) {
        const int idx = tid + i * kGemmThreads;
        As[idx % kBK][idx / kBK] = to_f(ra[i]);
      }
#pragma unroll
      for (int i = 0; i < kLoadsW; ++i) {
        const int idx = tid + i * kGemmThreads;
        if (!wt)
          Ws[idx / BN][idx % BN] = to_f(rw[i]);
        else
          Ws[idx % kBK][idx / kBK] = to_f(rw[i]);
      }
      __syncthreads();
      if (k0 + kBK < k_hi) load(k0 + kBK);  // in flight while we multiply
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= g.N) continue;
      if (g.ksplit == 1)
        epilogue<T>(g, z, gm, gn, acc[i][j]);
      else
        g.part[(((long long)ks * g.nz + z) * g.M + gm) * g.N + gn] =
            acc[i][j];
    }
  }
}

// Sum the ksplit partials of each output in slice order, then the
// epilogue.  One thread per output of every z-slice.
template <typename T>
__global__ void gemm_reduce_kernel(GemmArgs g) {
  const long long per_z = (long long)g.M * g.N;
  const long long n = per_z * g.nz;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int ks = 0; ks < g.ksplit; ++ks) v += g.part[ks * n + idx];
    const int z = (int)(idx / per_z);
    const long long r = idx % per_z;
    epilogue<T>(g, z, (int)(r / g.N), (int)(r % g.N), v);
  }
}

template <typename T, int BM, int BN, typename TA>
static int launch_tiles(GemmArgs g, int nz, cudaStream_t stream) {
  const int tiles = ((g.N + BN - 1) / BN) * ((g.M + BM - 1) / BM) * nz;
  int ktot = 0;
  for (int s = 0; s < 3; ++s)
    if (g.a[s] != nullptr) ktot += g.k[s];
  // about two blocks per SM, at least four k-tiles per slice, and the
  // partials within the scratch
  int ksplit = 1;
  if (g.part != nullptr && tiles < 2 * kSms) {
    ksplit = std::min((2 * kSms + tiles - 1) / tiles,
                      std::max(ktot / (4 * kBK), 1));
    const long long per_split = (long long)nz * g.M * g.N;
    ksplit = (int)std::min((long long)ksplit,
                           std::max(g.part_cap / per_split, 1LL));
  }
  g.nz = nz;
  g.kchunk = (((ktot + ksplit - 1) / ksplit) + kBK - 1) / kBK * kBK;
  g.ksplit = std::max((ktot + g.kchunk - 1) / g.kchunk, 1);
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, nz * g.ksplit);
  gemm_kernel<T, BM, BN, TA><<<grid, kGemmThreads, 0, stream>>>(g);
  int err = (int)cudaGetLastError();
  if (err != 0 || g.ksplit == 1) return err;
  const long long n = (long long)nz * g.M * g.N;
  const int blocks = (int)std::min((n + 255) / 256, 8LL * kSms);
  gemm_reduce_kernel<T><<<blocks, 256, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// TA is the type of the A sources (T unless a caller multiplies float32
// rows by T weights, as scn.cu does); W, biases, aux and C are T.
template <typename T, typename TA = T>
static int launch_gemm(const GemmArgs& g, int nz, cudaStream_t stream) {
  if (g.M < 1 || g.N < 1 || nz < 1 || g.epi < 0 || g.epi > kEpiF32Mul ||
      (g.aux2 != nullptr && g.aux2_div < 1))
    return (int)cudaErrorInvalidValue;
  if (g.M <= 32) return launch_tiles<T, 32, 128, TA>(g, nz, stream);
  return launch_tiles<T, 64, 64, TA>(g, nz, stream);
}

}  // namespace iic
