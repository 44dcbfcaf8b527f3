// Kernel 1's device code, and kernel 5's (attend_q.cuh instantiates the same
// kernel on int8 state): one additive-attention step for K beam lanes of
// each image, in one launch, one thread-block cluster per image.  Shared by
// attend.cu (kernel 1's C entry point), attend_q.cu (kernel 5's), step.cu
// (the chains of kernels 6, 6c and 13) and span.cu (kernel 7).
//
// Replaces indonesian_image_captioning_tpu/ops/attention_pallas.py
// attend_fused_mxu (body _make_kernel_mxu), and through it attend_fused,
// attend_fused_v3 and attend_fused_t, which compute the same values:
//
//   att[k, p] = wf . relu(ea[p] + dec[k])      (b_full dropped: softmax
//   alpha[k]  = softmax_p(att[k])               is shift-invariant)
//   awe[k]    = sum_p alpha[k, p] * enc[p]
//
// dec = h @ W_da + b_da arrives precomputed (B, K, A).  Inputs and outputs
// are float32 or bfloat16; all arithmetic is float32.  As in the Pallas
// kernel, wf is rounded to the input type, and so is alpha before the
// weighted sum.  Kernel 5's arithmetic is noted in attend_q.cuh.
//
// What bounds it: reading the encoder state once, P * (E + A) values per
// image (196 * 2,560 at the flagship widths: 2 MB at float32, 1 MB at
// bfloat16, 0.5 MB at int8), against about K * P * (3A + 2E) flops --
// under one flop per byte at K = 5, so device memory, not arithmetic;
// and, since the sum needs the whole softmax, the latency of each phase
// of a step, as every image's CTAs pass through them together.
//
// What the design does about it: one launch, a cluster of cs CTAs per
// image (AttendPlan, made by ops/attention_cuda.py attend_plan), for any K:
//   1. rank r stages the ea rows of its pixels [r pc, (r + 1) pc) in shared
//      memory by 16-byte cp.async copies between a scalar head and tail
//      (any A, any base address), and scores them for all K lanes, eight
//      at a time: a warp a pixel, each lane a stride of a, the eight
//      partial sums in registers, then a butterfly, no branch per lane;
//   2. each rank stores its scores into every rank's pixel-major table
//      through distributed shared memory, so after one cluster barrier
//      every rank holds the image's whole K x P table and runs its softmax
//      (no table reaches device memory; rank r writes alpha for its own
//      pixels);
//   3. rank r sums columns [r ec, (r + 1) ec) of awe over all P pixels:
//      its slice of enc streams through a ring of kAttStages stages of rs
//      rows, filled by 16-byte cp.async copies from every thread (the ring
//      shares its bytes with step 1's rows; its first stages are issued
//      before step 2, whose barrier and softmax hide their latency), and a
//      thread owns 2 columns (4 where 2 would take more than 512 threads)
//      and kAttLanes lanes: per pixel one shared load of its columns, two
//      16-byte loads of its lanes' alpha and 16 (32) FFMAs, one chain an
//      output in pixel order (so the float32 sums, and the decode records
//      of kernel 13 that depend on them, are those of a sequential sum).
// So every byte of enc and ea is read from device memory once a call.
// Only where the K x P table does not fit (the plan cuts K into slabs of
// ks lanes) or the (column, lane group) pairs outnumber 512 threads (K past
// 64 at the flagship widths) is enc read again, once a slab or a pass.  The
// plan keeps a CTA near 75 KB of shared memory at small K, so three fit an
// SM and a batch of 32 images' clusters runs in one wave.  A 16-byte chunk
// that is misaligned or crosses the row's end (E * itemsize not a multiple
// of 16) is copied one value at a time, on the same path.  The int8 values
// become floats by a byte permute and one add (no quarter-rate I2F).
// Caching: the encoder state is read with the default L2 policy (it stays
// in L2 where it fits, and a decode reads it again the next step); an
// evict-first hint on the copies (cp.async's L2::cache_hint) stopped the
// card with an illegal instruction, so it was not timed (PERF.md).
#pragma once

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace iic {

// The launch plan, ops/attention_cuda.py attend_plan; every field 8 bytes.
struct AttendPlan {
  long long cs;       // CTAs of a cluster: one image
  long long pc;       // pixels a rank scores
  long long pcs;      // of them, staged in shared memory at a time
  long long ec;       // columns a rank sums, a multiple of V
  long long ks;       // lanes a slab: the table holds ks lanes x P pixels
  long long threads;  // threads a CTA
  long long rs;       // enc rows a stage of the ring
  long long cols;     // columns a thread sums: 2 or 4
  long long smem;     // dynamic shared memory bytes
};

constexpr int kAttMaxThreads = 512;   // threads a CTA may take
constexpr int kAttLanes = 8;       // lanes a warp scores and a thread sums
constexpr int kAttStages = 6;      // stages of the enc ring

// Values of S a 16-byte copy moves.
template <typename S>
__host__ __device__ constexpr int att_v() {
  return 16 / (int)sizeof(S);
}

__host__ __device__ inline long long att_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// Byte offsets of the dynamic shared memory's parts; attend_plan mirrors
// it.  The table is pixel-major: lane k of pixel p at p * kst + k, kst =
// ks rounded up to kAttLanes, plus 4 (so a warp that reads one lane of 32
// pixels meets 4-way bank conflicts, not 8- or 32-way; the lanes past ks
// stay 0).  The staged ea rows and eight lanes of dec in T (the scoring)
// share their bytes with the enc ring (the weighted sum).
struct AttLayout {
  long long tab, dec, ea, ring, total, kst;
};

__host__ __device__ inline AttLayout att_layout(const AttendPlan& pl, int P,
                                                int A, int isz) {
  AttLayout L;
  L.kst = att_up(pl.ks, kAttLanes) + 4;
  L.tab = att_up(4LL * A, 16);                          // after wf (A,)
  L.dec = att_up(L.tab + 4LL * P * L.kst, 16);
  L.ea = att_up(L.dec + 4LL * kAttLanes * A + 16, 16);
  L.ring = L.dec;
  const long long score = L.ea + pl.pcs * A * isz + 16;
  const long long sum = L.ring + kAttStages * pl.rs * pl.ec * isz;
  L.total = score > sum ? score : sum;
  return L;
}

// Whether the plan covers P pixels, E columns and K lanes, and fits.
template <typename S>
static bool att_plan_ok(const AttendPlan& pl, int K, int P, int E, int A) {
  const AttLayout L = att_layout(pl, P, A, (int)sizeof(S));
  return pl.cs >= 1 && pl.cs <= 8 && pl.pc >= 1 && pl.cs * pl.pc >= P &&
         pl.pcs >= 1 && pl.pcs <= pl.pc && pl.ec >= att_v<S>() &&
         pl.ec % att_v<S>() == 0 && pl.cs * pl.ec >= E && pl.ks >= 1 &&
         pl.ks <= K && pl.threads >= 32 && pl.threads <= kAttMaxThreads &&
         pl.threads % 32 == 0 && (pl.cols == 2 || pl.cols == 4) &&
         pl.rs >= 1 && pl.smem >= L.total && pl.smem <= 232448;
}

// One call's arguments.  S: the state's storage (T, or int8_t for kernel
// 5, whose per-pixel float32 scales are enc_s and ea_s (B, P)).
struct AttendJob {
  const void* enc;      // (B, P, E) S
  const void* ea;       // (B, P, A) S
  const float* enc_s;   // (B, P) kernel 5
  const float* ea_s;    // (B, P) kernel 5
  const void* dec;      // (B, K, A) T
  const float* wf;      // (A,)
  void* awe;            // (B, K, E) T
  void* alpha;          // (B, K, pa) T, or null
  const void* gate;     // (B, K, E) T: awe = rt(gate rt(awe)) (kGate)
  const int* live;      // the decode's early-exit word, or null
  int K, P, pa, E, A;   // pa: the pixels that take part (kernel 5)
  int pc, pcs, ec, ks, rs, kst;
  int o_tab, o_dec, o_ea, o_ring;
};

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// Split arrive and wait of the cluster's barrier: arrive releases this
// thread's shared-memory accesses, wait acquires every CTA's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// S's bits.
template <typename S>
using AttRaw = std::conditional_t<
    sizeof(S) == 4, unsigned int,
    std::conditional_t<sizeof(S) == 2, unsigned short, unsigned char>>;

template <typename S>
__device__ __forceinline__ AttRaw<S> att_ld1(const S* p) {
  return __ldg((const AttRaw<S>*)p);
}

// cp.async: 16 bytes global -> shared without registers (kept in L2, not
// L1); groups committed and waited for in order.
__device__ __forceinline__ void att_cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void att_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void att_cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// all but the newest kAttStages - 1 groups
__device__ __forceinline__ void att_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAttStages - 1) : "memory");
}

// V values of S (16 bytes) from global to shared memory: one cp.async where
// src is 16-byte aligned and the values lie before `lim` (src + lim is the
// row's end), else value by value (zero past the end).
template <typename S>
__device__ __forceinline__ void att_copy16(unsigned char* dst, const S* src,
                                           int lim) {
  constexpr int V = att_v<S>();
  if (lim >= V && ((uintptr_t)src & 15) == 0) {
    att_cp16(dst, src);
  } else {
    AttRaw<S>* d = (AttRaw<S>*)dst;
    for (int v = 0; v < V; ++v) d[v] = v < lim ? att_ld1(src + v) : 0;
  }
}

// C (2 or 4) values of S at p in shared memory as floats, one load.
// int8: byte ^ 0x80 is q + 128; under the exponent of 2^23 it is the float
// 2^23 + q + 128, and one add leaves q (no quarter-rate I2F).
template <typename S, int C>
__device__ __forceinline__ void att_cols(const unsigned char* p, float* x) {
  if constexpr (std::is_same<S, float>::value) {
    if constexpr (C == 4) {
      const float4 v = *(const float4*)p;
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
      const float2 v = *(const float2*)p;
      x[0] = v.x, x[1] = v.y;
    }
  } else if constexpr (std::is_same<S, int8_t>::value) {
    const uint32_t u = (C == 4 ? *(const uint32_t*)p
                               : (uint32_t) * (const unsigned short*)p) ^
                       0x80808080u;
#pragma unroll
    for (int t = 0; t < C; ++t)
      x[t] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | t)) -
             8388736.0f;
  } else {   // a bf16's bits: a float's top half
    uint32_t w[2];
    if constexpr (C == 4) {
      const uint2 v = *(const uint2*)p;
      w[0] = v.x, w[1] = v.y;
    } else {
      w[0] = *(const uint32_t*)p;
    }
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Copy n values of S from src into shared memory at buf (n * sizeof(S) +
// 16 bytes) by cp.async: a scalar head up to src's first 16-byte boundary,
// 16-byte copies, a scalar tail (the caller commits and waits).  Returns
// where src[0] lands.
template <typename S>
__device__ const S* att_stage(unsigned char* buf, const S* src, int n) {
  constexpr int V = att_v<S>();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int head = min(n, (int)((16 - ((uintptr_t)src & 15)) & 15) /
                              (int)sizeof(S));
  AttRaw<S>* dst = (AttRaw<S>*)(buf + 16) - head;   // 16-byte aligned at
  for (int i = tid; i < head; i += nt) dst[i] = att_ld1(src + i);  // head
  const int nv = (n - head) / V;
  for (int i = tid; i < nv; i += nt)
    att_cp16(dst + head + i * V, src + head + i * V);
  for (int i = head + nv * V + tid; i < n; i += nt) dst[i] = att_ld1(src + i);
  return (const S*)dst;
}

// One attention step, blockIdx.x / cs the image, one cluster of cs CTAs.
// kQ (S = int8_t): kernel 5's arithmetic (attend_q.cuh).  C: the columns a
// thread sums (2 where that fills the threads, else 4).
template <typename T, typename S, bool kGate, int C>
__global__ void __launch_bounds__(kAttMaxThreads)
    attend_kernel(const __grid_constant__ AttendJob J) {
  constexpr bool kQ = std::is_same<S, int8_t>::value;
  constexpr int V = att_v<S>(), L = kAttLanes;
  namespace cg = cooperative_groups;
  if (skip(J.live)) return;   // every CTA of the launch reads the same word
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  const int b = blockIdx.x / cs;
  extern __shared__ __align__(16) unsigned char att_smem[];
  float* wf_s = (float*)att_smem;
  float* tab = (float*)(att_smem + J.o_tab);
  unsigned char* ring = att_smem + J.o_ring;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int K = J.K, pa = J.pa, E = J.E, A = J.A, kst = J.kst;
  const int p0 = min(pa, rank * J.pc), np = min(pa, p0 + J.pc) - p0;
  const int c0 = min(E, rank * J.ec), c1 = min(E, c0 + J.ec);
  const S* ea = (const S*)J.ea + (size_t)b * J.P * A;
  const S* enc = (const S*)J.enc + (size_t)b * J.P * E;
  const T* dec = (const T*)J.dec + (size_t)b * K * A;
  // the enc ring: stage st holds rows [st rs, (st + 1) rs) of columns
  // [c0, c1), rowb bytes a row, nch 16-byte chunks of it copied
  const int rowb = J.ec * (int)sizeof(S);
  const int nch = (c1 - c0 + V - 1) / V;
  const int nstage = (pa + J.rs - 1) / J.rs;
  auto issue = [&](int st) {   // stage st into slot st % kAttStages
    if (st < nstage) {
      unsigned char* slot = ring + (size_t)(st % kAttStages) * J.rs * rowb;
      const int r0 = st * J.rs, nr = min(J.rs, pa - r0);
      for (int i = tid; i < nr * nch; i += nt) {
        const int r = i / nch, j = i - r * nch, c = c0 + j * V;
        att_copy16<S>(slot + (size_t)r * rowb + j * 16,
                      enc + (size_t)(r0 + r) * E + c, E - c);
      }
    }
    att_cp_commit();
  };
  for (int a = tid; a < A; a += nt) wf_s[a] = rt<T>(J.wf[a]);
  // every rank writes its scores into every rank's table: the cluster's
  // barrier is passed once before each slab's first remote store (every
  // CTA has started, and has read its table of the slab before) and once
  // after its last (every store has landed)
  cluster_arrive();

  for (int k0 = 0; k0 < K; k0 += J.ks) {
    const int kn = min(J.ks, K - k0);
    cluster_wait();
    // 1. the scores of this rank's pixels for lanes k0 .. k0 + kn - 1,
    //    eight lanes at a time (dec's lanes past kn are 0, their scores
    //    are not kept)
    for (int i0 = 0; i0 < np; i0 += J.pcs) {
      const int ni = min(J.pcs, np - i0);
      const S* rows = att_stage<S>(att_smem + J.o_ea,
                                   ea + (size_t)(p0 + i0) * A, ni * A);
      for (int g0 = 0; g0 < kn; g0 += L) {
        const int gn = min(L, kn - g0);
        T* dec_s = (T*)att_stage<T>(att_smem + J.o_dec,
                                    dec + (size_t)(k0 + g0) * A, gn * A);
        for (int i = gn * A + tid; i < L * A; i += nt) dec_s[i] = from_f<T>(0);
        att_cp_commit();
        att_cp_wait_all();
        __syncthreads();
        for (int i = 2 * warp; i < ni; i += 2 * nwarps) {   // two pixels
          const int i1 = min(i + 1, ni - 1);                // a warp
          const S* row0 = rows + (size_t)i * A;
          const S* row1 = rows + (size_t)i1 * A;
          float sq0 = 0.0f, sq1 = 0.0f;
          if constexpr (kQ) {
            sq0 = rt<T>(J.ea_s[(size_t)b * J.P + p0 + i0 + i]);
            sq1 = rt<T>(J.ea_s[(size_t)b * J.P + p0 + i0 + i1]);
          }
          float acc0[L], acc1[L];
#pragma unroll
          for (int k = 0; k < L; ++k) acc0[k] = acc1[k] = 0.0f;
#pragma unroll 2
          for (int a = lane; a < A; a += 32) {
            const float x0 = kQ ? rt<T>(to_f(row0[a]) * sq0) : to_f(row0[a]);
            const float x1 = kQ ? rt<T>(to_f(row1[a]) * sq1) : to_f(row1[a]);
            const float w = wf_s[a];
#pragma unroll
            for (int k = 0; k < L; ++k) {
              const float d = to_f(dec_s[k * A + a]);
              const float e0 = fmaxf(rt<T>(x0 + d), 0.0f);
              const float e1 = fmaxf(rt<T>(x1 + d), 0.0f);
              acc0[k] += kQ ? rt<T>(e0 * w) : e0 * w;
              acc1[k] += kQ ? rt<T>(e1 * w) : e1 * w;
            }
          }
          float mine0 = 0.0f, mine1 = 0.0f;   // lane k keeps lane k's
#pragma unroll
          for (int k = 0; k < L; ++k) {
            const float v0 = warp_sum(acc0[k]), v1 = warp_sum(acc1[k]);
            if (lane == k) {
              mine0 = kQ ? rt<T>(v0) : v0;
              mine1 = kQ ? rt<T>(v1) : v1;
            }
          }
          if (lane < gn) {
            const size_t at0 = (size_t)(p0 + i0 + i) * kst + g0 + lane;
            const size_t at1 = (size_t)(p0 + i0 + i1) * kst + g0 + lane;
            for (int r = 0; r < cs; ++r) {
              float* t = cl.map_shared_rank(tab, r);
              t[at0] = mine0;
              t[at1] = mine1;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int st = 0; st < kAttStages - 1; ++st) issue(st);  // the ring's
    // 2. every rank's scores in every rank's table, then the softmax
    cluster_arrive();
    cluster_wait();
    for (int i = tid; i < pa * (kst - kn); i += nt)   // lanes past kn: 0
      tab[(size_t)(i / (kst - kn)) * kst + kn + i % (kst - kn)] = 0.0f;
    for (int k = warp; k < kn; k += nwarps) {
      float* t = tab + k;
      float m = -INFINITY;
      for (int p = lane; p < pa; p += 32) m = fmaxf(m, t[(size_t)p * kst]);
      m = warp_max(m);
      float s = 0.0f;
      for (int p = lane; p < pa; p += 32) {
        const float e = expf(t[(size_t)p * kst] - m);
        t[(size_t)p * kst] = e;
        s += e;
      }
      s = warp_sum(s);
      T* al = J.alpha == nullptr
                  ? nullptr
                  : (T*)J.alpha + ((size_t)b * K + k0 + k) * pa;
      for (int p = lane; p < pa; p += 32) {
        const float v = t[(size_t)p * kst] / s;
        const bool own = al != nullptr && p >= p0 && p < p0 + np;
        if constexpr (kQ) {
          if (own) al[p] = from_f<T>(v);
          t[(size_t)p * kst] = rt<T>(v * J.enc_s[(size_t)b * J.P + p]);
        } else {
          t[(size_t)p * kst] = rt<T>(v);
          if (own) al[p] = from_f<T>(rt<T>(v));
        }
      }
    }
    __syncthreads();
    // 3. awe's columns [c0, c1) of lanes k0 .. k0 + kn - 1 from the ring:
    //    a thread takes C columns and L lanes, one FFMA chain an output in
    //    pixel order
    const int G = (kn + L - 1) / L, items = (c1 - c0 + C - 1) / C * G;
    for (int it0 = 0; it0 < items; it0 += nt) {   // uniform in the block
      if (it0 > 0)                                 // another pass: restream
        for (int st = 0; st < kAttStages - 1; ++st) issue(st);
      const int item = it0 + tid;
      const bool on = item < items;
      const int q = on ? item / G : 0, kb = (on ? item % G : 0) * L;
      float acc[L][C];
#pragma unroll
      for (int k = 0; k < L; ++k)
#pragma unroll
        for (int v = 0; v < C; ++v) acc[k][v] = 0.0f;
      for (int st = 0; st < nstage; ++st) {
        issue(st + kAttStages - 1);
        att_cp_wait();
        __syncthreads();
        if (on) {
          const unsigned char* slot = ring +
                                      (size_t)(st % kAttStages) * J.rs * rowb +
                                      q * C * (int)sizeof(S);
          const int r0 = st * J.rs, nr = min(J.rs, pa - r0);
          const float* tb = tab + (size_t)r0 * kst + kb;
#pragma unroll 4
          for (int r = 0; r < nr; ++r) {
            float x[C], w[L];
            att_cols<S, C>(slot + (size_t)r * rowb, x);
            const float4 w0 = *(const float4*)(tb + (size_t)r * kst);
            const float4 w1 = *(const float4*)(tb + (size_t)r * kst + 4);
            w[0] = w0.x, w[1] = w0.y, w[2] = w0.z, w[3] = w0.w;
            w[4] = w1.x, w[5] = w1.y, w[6] = w1.z, w[7] = w1.w;
#pragma unroll
            for (int k = 0; k < L; ++k)
#pragma unroll
              for (int v = 0; v < C; ++v) acc[k][v] += w[k] * x[v];
          }
        }
        __syncthreads();   // the slot is free for the stage after next
      }
      if (on) {
        const int c = c0 + q * C;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          if (kb + k >= kn) continue;
          const size_t at = ((size_t)b * K + k0 + kb + k) * E + c;
          T* out = (T*)J.awe + at;
#pragma unroll
          for (int v = 0; v < C; ++v) {
            if (c + v >= c1) continue;
            if constexpr (kGate)
              out[v] = from_f<T>(to_f(((const T*)J.gate)[at + v]) *
                                 rt<T>(acc[k][v]));
            else
              out[v] = from_f<T>(acc[k][v]);
          }
        }
      }
    }
    __syncthreads();
    if (k0 + J.ks < K) cluster_arrive();   // this rank's table is free
  }
}

// Launch attend_kernel: grid B * cs, cluster cs; alpha, gate and live may
// be null.  Returns the CUDA error code.
template <typename T, typename S, bool kGate, int C>
static int launch_attend_cols(AttendJob J, const AttendPlan& pl, int B,
                              cudaStream_t stream) {
  if (B < 1 || J.K < 1 || J.pa < 1 || J.pa > J.P || J.E < 1 || J.A < 1 ||
      !att_plan_ok<S>(pl, J.K, J.pa, J.E, J.A))
    return (int)cudaErrorInvalidValue;
  const AttLayout L = att_layout(pl, J.pa, J.A, (int)sizeof(S));
  J.pc = (int)pl.pc, J.pcs = (int)pl.pcs, J.ec = (int)pl.ec;
  J.ks = (int)pl.ks, J.rs = (int)pl.rs, J.kst = (int)L.kst;
  J.o_tab = (int)L.tab, J.o_dec = (int)L.dec, J.o_ea = (int)L.ea;
  J.o_ring = (int)L.ring;
  auto kernel = attend_kernel<T, S, kGate, C>;
  int err = allow_smem(kernel, (size_t)pl.smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * pl.cs));
  cfg.blockDim = dim3((unsigned)pl.threads);
  cfg.dynamicSmemBytes = (size_t)pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)pl.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, J);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

template <typename T, typename S, bool kGate>
static int launch_attend_cluster(const AttendJob& J, const AttendPlan& pl,
                                 int B, cudaStream_t stream) {
  return pl.cols == 2
             ? launch_attend_cols<T, S, kGate, 2>(J, pl, B, stream)
             : launch_attend_cols<T, S, kGate, 4>(J, pl, B, stream);
}

// Kernel 1: enc, ea (B, P, E|A) and dec (B, K, A) in T, wf (A,) float32;
// awe (B, K, E) and alpha (B, K, P; may be null) in T.  With a gate (B, K,
// E) awe receives rt(gate rt(awe)).  Returns the CUDA error code.
template <typename T>
static int launch_attend(const void* enc, const void* ea, const void* dec,
                         const void* wf, void* awe, void* alpha, int B, int K,
                         int P, int E, int A, const AttendPlan& plan,
                         cudaStream_t stream, const int* live = nullptr,
                         const void* gate = nullptr) {
  AttendJob J = {};
  J.enc = enc, J.ea = ea, J.dec = dec, J.wf = (const float*)wf;
  J.awe = awe, J.alpha = alpha, J.gate = gate, J.live = live;
  J.K = K, J.P = P, J.pa = P, J.E = E, J.A = A;
  return gate ? launch_attend_cluster<T, T, true>(J, plan, B, stream)
              : launch_attend_cluster<T, T, false>(J, plan, B, stream);
}

}  // namespace iic
