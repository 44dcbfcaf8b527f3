// Kernel 10: exact per-row top-k of an (R, V) table, any k, in one pass
// up to k = 32.
//
// Replaces indonesian_image_captioning_tpu/ops/topk_pallas.py
// row_topk_pallas (body _make_kernel).  Its contract holds: the k largest
// values of each row that exceed NEG, in descending order, equal values in
// index order (lax.top_k's first occurrence first); slots past the row's
// last such value get (NEG, 0), as the Pallas kernel's initial registers
// stay; values are compared in float32 and returned in the table's type,
// indices int32.  On tables whose values are >= NEG, as the beam's
// candidate tables are (clamped at NEG), that is row_topk_iterative's
// result, value for value.
//
// What bounds it: reading the table once, R * V values, against a few
// comparisons per value -- device memory bandwidth.
//
// What the design does about it: one block per row reads the row once,
// neighbouring threads on neighbouring values, four loads in flight per
// thread; each thread keeps its own sorted top-k in registers (a strictly
// greater value enters, so an equal later index stays behind), and the
// block merges the per-thread lists in k rounds of a (value, index)
// maximum.  Nothing but the k winners reaches device memory.  A thread's
// list has KK >= k slots: k itself up to 8, then 16 or 32, with 128
// threads a block past 8 so the lists stay within 32 KB of shared memory.
// Past 32 the kernel runs in passes of 32 slots: pass p reads the row
// again and takes only the values that come after pass p - 1's last
// winner (read back from the output) in the (value desc, index asc)
// order, so the table is read ceil(k / 32) times and no list grows.
#include <algorithm>
#include <climits>
#include <cmath>

#include "common.cuh"

namespace iic {

template <int KK>
constexpr int topk_threads() { return KK <= 8 ? 256 : 128; }

template <typename T, int KK, int kTopkThreads = topk_threads<KK>()>
__global__ void __launch_bounds__(kTopkThreads)
row_topk_kernel(const T* __restrict__ x, int V, int k, int q0, int kk,
                T* __restrict__ vals, int* __restrict__ idx) {
  __shared__ float sv[KK][kTopkThreads];
  __shared__ int si[KK][kTopkThreads];
  __shared__ float wv[kTopkThreads / 32];
  __shared__ int wi[kTopkThreads / 32];
  __shared__ int s_win;
  const int tid = threadIdx.x;
  const T* row = x + (long long)blockIdx.x * V;
  T* out_v = vals + (long long)blockIdx.x * k;
  int* out_i = idx + (long long)blockIdx.x * k;
  // slots q0.. take what comes after slot q0 - 1's winner (tv, ti)
  const float tv = q0 > 0 ? to_f(out_v[q0 - 1]) : INFINITY;
  const int ti = q0 > 0 ? out_i[q0 - 1] : -1;

  float lv[KK];
  int li[KK];
#pragma unroll
  for (int q = 0; q < KK; ++q) {
    lv[q] = kNeg;
    li[q] = INT_MAX;
  }
  auto insert = [&](float v, int j) {
    if (!(v > lv[KK - 1])) return;   // also keeps values <= NEG out
    if (!(v < tv || (v == tv && j > ti))) return;
    bool placed = false;
#pragma unroll
    for (int p = KK - 1; p > 0; --p) {
      if (!placed) {
        if (v > lv[p - 1]) {
          lv[p] = lv[p - 1];
          li[p] = li[p - 1];
        } else {
          lv[p] = v;
          li[p] = j;
          placed = true;
        }
      }
    }
    if (!placed) {
      lv[0] = v;
      li[0] = j;
    }
  };
  constexpr int kStep = 4 * kTopkThreads;
  int j0 = 0;
  for (; j0 + kStep <= V; j0 += kStep) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = to_f(row[j0 + u * kTopkThreads + tid]);
#pragma unroll
    for (int u = 0; u < 4; ++u) insert(v[u], j0 + u * kTopkThreads + tid);
  }
  for (int j = j0 + tid; j < V; j += kTopkThreads) insert(to_f(row[j]), j);
#pragma unroll
  for (int q = 0; q < KK; ++q) {
    sv[q][tid] = lv[q];
    si[q][tid] = li[q];
  }

  // kk rounds: every thread offers the head of its list; the (value desc,
  // index asc) maximum wins and its owner moves to its next entry.
  int head = 0;
  const int lane = tid & 31, warp = tid >> 5;
  for (int q = 0; q < kk; ++q) {
    float bv = head < KK ? sv[head][tid] : kNeg;
    int bi = head < KK ? si[head][tid] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kTopkThreads / 32; ++w) {
        if (wv[w] > bv || (wv[w] == bv && wi[w] < bi)) {
          bv = wv[w];
          bi = wi[w];
        }
      }
      const bool real = bv > kNeg;
      out_v[q0 + q] = from_f<T>(real ? bv : kNeg);
      out_i[q0 + q] = real ? bi : 0;
      s_win = real ? bi : -1;
    }
    __syncthreads();
    if (head < KK && si[head][tid] == s_win) ++head;
    __syncthreads();
  }
}

template <typename T>
static int launch_row_topk(const void* x, int R, int V, int k, void* vals,
                           void* idx, cudaStream_t s) {
  const dim3 grid(R), block(topk_threads<8>());
  switch (k) {
#define IIC_TOPK_CASE(KK)                                                  \
  case KK:                                                                 \
    row_topk_kernel<T, KK><<<grid, block, 0, s>>>((const T*)x, V, k, 0, k, \
                                                  (T*)vals, (int*)idx);    \
    break;
    IIC_TOPK_CASE(1)
    IIC_TOPK_CASE(2)
    IIC_TOPK_CASE(3)
    IIC_TOPK_CASE(4)
    IIC_TOPK_CASE(5)
    IIC_TOPK_CASE(6)
    IIC_TOPK_CASE(7)
    IIC_TOPK_CASE(8)
#undef IIC_TOPK_CASE
    default:
      if (k <= 16) {
        row_topk_kernel<T, 16><<<grid, topk_threads<16>(), 0, s>>>(
            (const T*)x, V, k, 0, k, (T*)vals, (int*)idx);
        break;
      }
      for (int q0 = 0; q0 < k; q0 += 32) {   // passes of 32 slots
        row_topk_kernel<T, 32><<<grid, topk_threads<32>(), 0, s>>>(
            (const T*)x, V, k, q0, std::min(32, k - q0), (T*)vals,
            (int*)idx);
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
      }
  }
  return (int)cudaGetLastError();
}

}  // namespace iic

// x (R, V) in the dtype's storage, row-major; vals (R, k) in the same type,
// idx (R, k) int32.  Returns the launch's CUDA error code.
extern "C" int iic_row_topk(int dtype, const void* x, int R, int V, int k,
                            void* vals, void* idx, void* stream) {
  if (R < 1 || V < 1 || k < 1 || k > V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::launch_row_topk<float>(x, R, V, k, vals, idx, s);
  if (dtype == iic::kBF16)
    return iic::launch_row_topk<__nv_bfloat16>(x, R, V, k, vals, idx, s);
  return (int)cudaErrorInvalidValue;
}
