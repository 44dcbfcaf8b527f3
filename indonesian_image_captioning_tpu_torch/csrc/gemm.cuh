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
  const int* live;     // the megakernel's early-exit word, or null
};

constexpr int kSms = 132;

template <typename T>
__device__ __forceinline__ void epilogue(const GemmArgs& g, int z, int gm,
                                         int gn, float v) {
  const T* b1 = g.bias1 ? (const T*)g.bias1 + z * g.zb : nullptr;
  const T* b2 = g.bias2 ? (const T*)g.bias2 + z * g.zb : nullptr;
  const T* aux = g.aux ? (const T*)g.aux + z * g.zc : nullptr;
  const int col = z * g.zc + gn;
  float aux2v = 0.0f;
  if (g.aux2 != nullptr) {
    const long long ai = (gm / g.aux2_div) * g.ldaux2 + col;
    aux2v = g.aux2_f32 ? ((const float*)g.aux2)[ai]
                       : to_f(((const T*)g.aux2)[ai]);
  }
  float v2 = 0.0f;    // the second output, where the epilogue has one
  switch (g.epi) {
    case kEpiBias:
      v = rt<T>(v);
      if (b1) v = rt<T>(v + to_f(b1[gn]));
      break;
    case kEpiPre:
      if (b1) v += to_f(b1[gn]);
      if (b2) v += to_f(b2[gn]);
      if (aux) v += to_f(aux[gm * g.ldaux + gn]);
      break;
    case kEpiSigmoidMul: {
      float x = rt<T>(v);
      if (b1) x = rt<T>(x + to_f(b1[gn]));
      const float gate = rt<T>(sigmoidf_(x));
      v = rt<T>(gate * to_f(aux[gm * g.ldaux + gn]));
      break;
    }
    case kEpiMul:
      v = rt<T>(rt<T>(v) * to_f(aux[gm * g.ldaux + gn]));
      break;
    case kEpiAddMul:
      v = rt<T>(rt<T>(v) + to_f(aux[gm * g.ldaux + gn]));
      v2 = v * aux2v;
      break;
    case kEpiGate:
      v = sigmoidf_(v + (b1 ? to_f(b1[gn]) : 0.0f));
      v2 = rt<T>(v) * to_f(aux[gm * g.ldaux + gn]);
      break;
    case kEpiRawMul:
      v2 = v * aux2v;
      break;
    case kEpiFacBwd:
      g.acc[gm * g.ldacc + col] += v * aux2v;
      v = v * to_f(aux[gm * g.ldaux + gn]);
      break;
    case kEpiGateBwd: {
      const float d_gate = v * to_f(aux[gm * g.ldaux + gn]);
      v2 = v * aux2v;
      v = d_gate * aux2v * (1.0f - aux2v);
      break;
    }
    case kEpiF32Mul:
      v = v * to_f(aux[gm * g.ldaux + gn]);
      break;
  }
  const long long ci = gm * g.ldc + col;
  if (g.c_f32)
    ((float*)g.c)[ci] = v;
  else
    ((T*)g.c)[ci] = from_f<T>(v);
  if (g.c2 != nullptr) ((T*)g.c2)[gm * g.ldc2 + col] = from_f<T>(v2);
}

template <typename T, int BM, int BN, typename TA>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  static_assert((BM / 4) * (BN / 4) == kGemmThreads, "4 x 4 per thread");
  if (skip(g.live)) return;
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
  if (skip(g.live)) return;
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
