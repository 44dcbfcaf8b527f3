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
// comparisons per value -- device memory bandwidth, 4.33 MB at the "steps"
// rung's (32, 33,815) float32 table, 1.3 us at 3.35 TB/s.  At that size
// the first design (one block a row: 32 blocks on 132 SMs, scalar loads,
// k block-wide rounds with three barriers each) was held back by latency:
// a quarter of the SMs streamed, each its whole row, then merged slowly.
// This one is held back by latency too, in smaller steps: at 8 CTAs of
// 128 threads a row a thread reads about eight 16-byte vectors, so the
// launch, the inserts into the lists, the two cluster barriers and the
// three merges weigh about as much as the loads.
//
// What the design does about it: a row is a thread-block cluster of cs
// CTAs of 128 threads (the plan, ops/topk.py topk_plan: up to 16 CTAs, so
// a small batch still puts work on every SM; 8 at (32, 33,815), one at
// (160, 6,763)).  Each CTA streams a contiguous slice of the row
// in 16-byte loads (4 float32 or 8 bf16 values, four in flight a thread);
// the row's unaligned head (before its first 16-byte boundary) goes to
// rank 0 and its ragged tail to rank cs - 1, one value a thread.  Every
// thread keeps a sorted list of KK >= k (value, index) pairs in registers
// (a strictly greater value enters, so an equal later index stays behind;
// a value that does not beat the list's last costs one compare).  The
// merges keep the (value desc, index asc) order and pass no block-wide
// barrier per slot: each warp merges its 32 lists in k rounds of a
// shuffle maximum (the winner pops its head); warp 0 merges the warps'
// lists, one a lane, the same way; every CTA stores its k winners into
// rank 0's shared memory (distributed shared memory), and after the
// cluster's barrier rank 0's warp 0 merges the cs lists and writes the k
// winners.  Nothing but the winners reaches device memory.  KK is k itself
// up to 8, then 16 or 32.
// Past 32 the kernel runs in passes of 32 slots: pass p reads the row
// again and takes only the values that come after pass p - 1's last
// winner (read back from the output) in the (value desc, index asc)
// order, so the table is read ceil(k / 32) times and no list grows.
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"

namespace iic {

constexpr int kTopkMaxThreads = 256;
constexpr int kTopkMaxCluster = 16;

// ops/topk.py TopkPlan, field for field: the CTAs of a row's cluster, the
// threads a CTA, a thread's list slots (1-8, 16 or 32).
struct TopkPlan {
  long long cs, threads, kk;
};

__device__ __forceinline__ void topk_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void topk_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void topk_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 16 bytes of the table, read once (no L1 allocation).
__device__ __forceinline__ uint4 topk_ld16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// The 16 bytes' values as float32.
template <typename T>
__device__ __forceinline__ void topk_unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void topk_unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void topk_unpack<__nv_bfloat16>(const uint4& u,
                                                           float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

// (v, i) comes before (w, j) in the (value desc, index asc) order.
__device__ __forceinline__ bool topk_before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// The warp's merge: every lane holds a sorted list (lv, li) of KK pairs;
// n rounds (n <= 32) of the warp's (value desc, index asc) maximum over
// the lists' heads, whose owner pops it.  Lane q returns round q's winner
// in (wv, wi).
template <int KK>
__device__ __forceinline__ void topk_warp_merge(float (&lv)[KK], int (&li)[KK],
                                                int n, float& wv, int& wi) {
  const int lane = threadIdx.x & 31;
  wv = kNeg;
  wi = INT_MAX;
  for (int q = 0; q < n; ++q) {
    float bv = lv[0];
    int bi = li[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (topk_before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == q) {
      wv = bv;
      wi = bi;
    }
    if (li[0] == bi && bi != INT_MAX) {   // this lane's head won: pop it
#pragma unroll
      for (int p = 0; p + 1 < KK; ++p) {
        lv[p] = lv[p + 1];
        li[p] = li[p + 1];
      }
      lv[KK - 1] = kNeg;
      li[KK - 1] = INT_MAX;
    }
  }
}

// Grid cs * R, clusters of cs CTAs (rank c of row r is block r cs + c);
// slots q0 .. q0 + kk - 1 of each row's output.
template <typename T, int KK>
__global__ void __launch_bounds__(kTopkMaxThreads)
    row_topk_kernel(const T* __restrict__ x, int V, int k, int q0, int kk,
                    T* __restrict__ vals, int* __restrict__ idx) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float wv_s[kTopkMaxThreads / 32][KK];   // the warps' winners
  __shared__ int wi_s[kTopkMaxThreads / 32][KK];
  __shared__ float cv_s[kTopkMaxCluster][KK];        // rank 0: the CTAs'
  __shared__ int ci_s[kTopkMaxCluster][KK];
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  unsigned cs_u;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(cs_u));
  const int cs = (int)cs_u;
  const int rank = (int)cl.block_rank();
  const int r = blockIdx.x / cs;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  topk_cluster_arrive_relaxed();   // every CTA has started: waited below

  const T* row = x + (long long)r * V;
  T* out_v = vals + (long long)r * k;
  int* out_i = idx + (long long)r * k;
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

  // the row's slices (ops/topk.py topk_slices): head values [0, h) before
  // its first 16-byte boundary (rank 0), nv whole vectors from h, rank c
  // taking vectors [nv c / cs, nv (c + 1) / cs), the tail [h + nv E, V)
  // (rank cs - 1).  A thread's values come in index order.
  const int h = min((int)(((16 - ((uintptr_t)row & 15)) & 15) / sizeof(T)), V);
  const int nv = (V - h) / E;
  const int v0 = (int)((long long)nv * rank / cs);
  const int v1 = (int)((long long)nv * (rank + 1) / cs);
  if (rank == 0 && tid < h) insert(to_f(row[tid]), tid);
  const uint4* vec = (const uint4*)(row + h);
  constexpr int U = 4;
  for (int j = v0 + tid; j < v1; j += U * nt) {
    uint4 buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + u * nt < v1) buf[u] = topk_ld16(vec + j + u * nt);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + u * nt < v1) {
        float f[E];
        topk_unpack<T>(buf[u], f);
        const int j0 = h + (j + u * nt) * E;
#pragma unroll
        for (int e = 0; e < E; ++e) insert(f[e], j0 + e);
      }
    }
  }
  const int t0 = h + nv * E;
  if (rank == cs - 1 && t0 + tid < V) insert(to_f(row[t0 + tid]), t0 + tid);

  // 1. each warp's kk winners, 2. the CTA's, in warp 0
  float wv;
  int wi;
  topk_warp_merge<KK>(lv, li, kk, wv, wi);
  if (lane < kk) {
    wv_s[warp][lane] = wv;
    wi_s[warp][lane] = wi;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < KK; ++q) {
      const bool in = lane < nw && q < kk;
      lv[q] = in ? wv_s[lane][q] : kNeg;
      li[q] = in ? wi_s[lane][q] : INT_MAX;
    }
    topk_warp_merge<KK>(lv, li, kk, wv, wi);
  }
  // 3. the cluster's: every CTA's winners into rank 0's table, merged there
  topk_cluster_wait();
  if (warp == 0 && lane < kk) {
    float* cv = cl.map_shared_rank(&cv_s[0][0], 0);
    int* ci = cl.map_shared_rank(&ci_s[0][0], 0);
    cv[rank * KK + lane] = wv;
    ci[rank * KK + lane] = wi;
  }
  topk_cluster_arrive();
  topk_cluster_wait();
  if (rank != 0 || warp != 0) return;
#pragma unroll
  for (int q = 0; q < KK; ++q) {
    const bool in = lane < cs && q < kk;
    lv[q] = in ? cv_s[lane][q] : kNeg;
    li[q] = in ? ci_s[lane][q] : INT_MAX;
  }
  topk_warp_merge<KK>(lv, li, kk, wv, wi);
  if (lane < kk) {
    const bool real = wv > kNeg;
    out_v[q0 + lane] = from_f<T>(real ? wv : kNeg);
    out_i[q0 + lane] = real ? wi : 0;
  }
}

template <typename T, int KK>
static int launch_topk_pass(const void* x, int R, int V, int k, int q0,
                            int kk, void* vals, void* idx,
                            const TopkPlan& pl, cudaStream_t s) {
  const auto kernel = row_topk_kernel<T, KK>;
  static bool ready = false;   // the attribute, once per instance
  if (!ready) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != 0) return err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(pl.cs * R));
  cfg.blockDim = dim3((unsigned)pl.threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)pl.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel, (const T*)x, V, k, q0,
                                          kk, (T*)vals, (int*)idx);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_row_topk(const void* x, int R, int V, int k, void* vals,
                           void* idx, const TopkPlan& pl, cudaStream_t s) {
  switch (pl.kk) {
#define IIC_TOPK_CASE(KK) \
  case KK:                \
    return launch_topk_pass<T, KK>(x, R, V, k, 0, k, vals, idx, pl, s);
    IIC_TOPK_CASE(1)
    IIC_TOPK_CASE(2)
    IIC_TOPK_CASE(3)
    IIC_TOPK_CASE(4)
    IIC_TOPK_CASE(5)
    IIC_TOPK_CASE(6)
    IIC_TOPK_CASE(7)
    IIC_TOPK_CASE(8)
    IIC_TOPK_CASE(16)
#undef IIC_TOPK_CASE
    case 32:
      for (int q0 = 0; q0 < k; q0 += 32) {   // passes of 32 slots
        const int err = launch_topk_pass<T, 32>(
            x, R, V, k, q0, k - q0 < 32 ? k - q0 : 32, vals, idx, pl, s);
        if (err != 0) return err;
      }
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

static bool topk_plan_ok(const TopkPlan& pl, int k) {
  const bool kk_ok = pl.kk == 16 || pl.kk == 32 || (pl.kk >= 1 && pl.kk <= 8);
  return kk_ok && pl.cs >= 1 && pl.cs <= kTopkMaxCluster &&
         pl.threads >= 32 && pl.threads <= kTopkMaxThreads &&
         pl.threads % 32 == 0 && (pl.kk == 32 ? k > 16 : k <= pl.kk);
}

}  // namespace iic

// x (R, V) in the dtype's storage, row-major; vals (R, k) in the same type,
// idx (R, k) int32; plan ops/topk.py topk_plan's.  Returns the launches'
// CUDA error code.
extern "C" int iic_row_topk(int dtype, const void* x, int R, int V, int k,
                            void* vals, void* idx, const void* plan,
                            void* stream) {
  const iic::TopkPlan& pl = *(const iic::TopkPlan*)plan;
  if (R < 1 || V < 1 || k < 1 || k > V || !iic::topk_plan_ok(pl, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::launch_row_topk<float>(x, R, V, k, vals, idx, pl, s);
  if (dtype == iic::kBF16)
    return iic::launch_row_topk<__nv_bfloat16>(x, R, V, k, vals, idx, pl, s);
  return (int)cudaErrorInvalidValue;
}
