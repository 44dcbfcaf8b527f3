// The tensor-core GEMM of the decode step chain (span.cu: kernels 7 and
// 13; step.cu: kernels 2, 6b and 6c), with gemm.cuh's contract:
//
//   C[z] = epilogue(A1[z] @ W1[z] + A2[z] @ W2[z] + A3[z] @ W3[z])
//
// the same GemmArgs (up to three sources, the z-offsets), the same
// epilogues (gemm.cuh epilogue<T>) and the same split-K with its ordered
// second pass (gemm_reduce_kernel).  A and W share the type T.  Every W
// comes packed as ops/step_cuda.py pack_tc packs the chain's weights:
// stored (N, K) (wt[s] = 1) and, at float32, split into TF32 hi parts (w)
// and lo parts (w_lo); launch_gemm_tc refuses any other W.
//
// The products run on Hopper's tensor cores, wgmma on sm_90a, 64 x 64
// outputs per warpgroup, K in tiles of 128 bytes (32 float32 or 64 bf16
// values):
//
// - bfloat16: wgmma.m64n64k16 on bf16 operands, float32 sums, the
//   epilogue rounding where the Pallas body rounds (rt<T>), as the FFMA
//   GEMM does.
// - float32: 3xTF32.  Each operand x is split into two TF32 values, hi =
//   tf32(x) and lo = tf32(x - hi), and C sums lo.hi + hi.lo + hi.hi with
//   wgmma.m64n64k8: the products of hi and lo parts keep about float32's
//   precision, where plain TF32 (one product of hi parts) keeps ten bits
//   and stays off (ROADMAP.md, "Precision").  Ids and scores never go
//   through a product; they move by indexed loads.
// - Each K tile's tensor-core sums go into fresh registers and are added
//   into the float32 accumulator after the tile (the tensor cores'
//   accumulation truncates; over a whole K it drifted past the 51-step
//   megakernel's 1e-4 score tolerance, per tile it stays within it).
//
// Shared memory holds K-major tiles in the 128-byte swizzle (16-byte
// chunk c of row r at c ^ (r % 8), 1024-byte atoms), which keeps wgmma's
// reads free of bank conflicts.  A producer warpgroup keeps a ring of
// stages full ("full" mbarrier when a stage's copies landed, "empty" when
// its products are done), and kNC consumer warpgroups (64 rows each)
// split A at float32 and run the wgmma, so loads leave the products'
// critical path.  A chunk is one 16-byte cp.async where its source row is
// 16-byte aligned (every chain shape), else eight or four element loads
// (a width that is not a multiple of 16 bytes, as the card tests' ragged
// shapes are); a ragged edge is filled with zeros.
//
// What bounds the chain's products at the serving shape (R = B * K = 160
// rows): operations, ~17.6 GFLOP per kernel-7 call of four SCN steps,
// three times over at float32 (3xTF32 at 495 TFLOP/s: 0.107 ms; bf16 at
// 989: 0.018 ms), against the FFMA GEMM's 67 TFLOP/s float32 peak.  What
// holds this first version back is the loads, not the tensor cores: with
// the wgmma removed it runs about as long (PERF.md), since every
// block reads its A tile again and W once per row tile.  Occupancy: a
// product with fewer output tiles than two per SM splits K over blocks
// (launch_gemm_tc), as gemm.cuh does.
#pragma once

#include <cstdint>

#include "gemm.cuh"

namespace iic {

// Host-side count of launch_gemm_tc's GEMM launches in this library.
inline int tc_launches = 0;

constexpr int kTcBM = 64, kTcBN = 64;
constexpr int kTcThreads = 128;   // one warpgroup

// Per type: a K tile of 128 bytes (32 float32 or 64 bf16 values), the
// elements in 16 bytes, the wgmma k-steps in a tile (32 bytes each), a
// 64-row tile of one part (hi or lo), and the block: kNC consumer
// warpgroups (64 rows each) share every W tile.  At float32 two: a
// 160-row product then takes two row tiles and reads W (hi and lo)
// twice, not three times.  At bf16 one, which measured faster there
// (PERF.md).  Stage: A hi, [A lo] (kNC * 64 rows each), W hi, [W
// lo] (64 rows each).
template <typename T>
struct Tc {
  static constexpr int kBK = 128 / sizeof(T);
  static constexpr int kEpc = 16 / sizeof(T);
  static constexpr int kSteps = 4;
  static constexpr int kTile = kTcBM * kBK;      // elements of one part
  static constexpr int kParts = sizeof(T) == 4 ? 2 : 1;   // hi, lo
  static constexpr int kNC = sizeof(T) == 4 ? 2 : 1;
  static constexpr int kBM = kNC * kTcBM;
  static constexpr int kStages = sizeof(T) == 4 ? 2 : 4;
  static constexpr int kThreads = (kNC + 1) * kTcThreads;   // + producers
  static constexpr int kStage = (kNC + 1) * kParts * kTile;
  static constexpr size_t kSmem =
      sizeof(T) * (size_t)kStages * kStage + 16 * kStages + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The shared-memory writes of this thread become visible to the tensor
// cores' (async proxy) reads after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// A wgmma matrix descriptor for a K-major tile whose rows are 128 bytes,
// in the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)), in
// 1024-byte atoms of 8 rows: SBO the 1024 bytes to the next 8 rows; LBO
// is not used.  p may step along K inside the row, 32 bytes a wgmma.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  uint64_t d = (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // LBO (unused)
  d |= (uint64_t)(1024 >> 4) << 32;  // SBO
  d |= (uint64_t)1 << 62;            // 128-byte swizzle; base offset 0
  return d;
}

#define IIC_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define IIC_D32_OUT(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (64 x 64, float32) += A (64 x k) . B (64 x k)^T, both K-major.
template <typename T>
__device__ __forceinline__ void wgmma_64x64(float* d, uint64_t da,
                                            uint64_t db);
template <>
__device__ __forceinline__ void wgmma_64x64<float>(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " IIC_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : IIC_D32_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_64x64<__nv_bfloat16>(float* d,
                                                           uint64_t da,
                                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " IIC_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : IIC_D32_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all(float* d) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Holds bar's phase until this thread's earlier cp.async copies have
// landed (a net-zero pending count: the thread still arrives itself).
__device__ __forceinline__ void cp_async_mbar_track(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Consumer warpgroup wg's own barrier (no other warpgroup is in it).
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kTcThreads)
               : "memory");
}

// One 16-byte chunk of a tile row: elements gk.. of row src (n of them
// real, the rest zero) into dst, by cp.async where al (the row and gk
// 16-byte aligned), else element by element.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int gk,
                                           int n, bool al) {
  constexpr int E = Tc<T>::kEpc;
  if (al) {
    cp_async16(dst, n > 0 ? src + gk : src, n * (int)sizeof(T));
    return;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = e < n ? src[gk + e] : from_f<T>(0.0f);
}

// kAl: every source row is 16-byte aligned (tc_aligned), so every chunk
// is one cp.async and the stage's "full" arrival is the copies' own.
template <typename T, bool kAl>
__global__ void __launch_bounds__(Tc<T>::kThreads)
    gemm_tc_kernel(GemmArgs g) {
  using C = Tc<T>;
  constexpr int E = C::kEpc;
  constexpr int S = C::kStages;
  constexpr int NC = C::kNC;
  constexpr int kA = NC * C::kTile;           // one part of the A tile
  constexpr bool kF32 = sizeof(T) == 4;
  if (skip(g.live)) return;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  T* ring = (T*)(((uintptr_t)tc_smem + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(ring + (size_t)S * C::kStage);
  uint64_t* empty = full + S;
  const int z = blockIdx.z / g.ksplit;
  const int ks = blockIdx.z % g.ksplit;
  const int m0 = blockIdx.y * C::kBM;
  const int n0 = blockIdx.x * kTcBN;
  const int tid = threadIdx.x;

  // this block's slice [lo, hi) of the sources' concatenated K, as tiles
  // of each source
  const int lo = ks * g.kchunk, hi = lo + g.kchunk;
  int k_lo[3], k_hi[3], tiles[3];
  int total = 0, off = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    tiles[s] = 0;
    k_lo[s] = k_hi[s] = 0;
    if (g.a[s] == nullptr) continue;
    k_lo[s] = max(lo - off, 0);
    k_hi[s] = min(hi - off, g.k[s]);
    off += g.k[s];
    if (k_lo[s] < k_hi[s])
      tiles[s] = (k_hi[s] - k_lo[s] + C::kBK - 1) / C::kBK;
    total += tiles[s];
  }

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], kTcThreads);      // the producers
      mbar_init(&empty[s], NC * kTcThreads); // the consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NC * kTcThreads) {
    // ---- the producer warpgroup: thread p copies 16-byte chunk p % 8 of
    // rows p / 8 + 16 j of each tile (A: j < 4 NC; W: j < 4), eight
    // threads a 128-byte row
    const int p = tid - NC * kTcThreads;
    const int c = p & 7, r0 = p >> 3;
    auto al16 = [](const void* q) { return (uintptr_t)q % 16 == 0; };
    int src_s = -1;
    bool al_a = kAl, al_w = kAl;      // constant under kAl
    const T *A = nullptr, *W = nullptr;
    const T* Wl = nullptr;
    long long oa[4 * NC], ow[4];      // the rows' offsets in A and W
    int na[4 * NC], nw[4];            // whether the rows exist
    for (int t = 0; t < total; ++t) {
      const int st = t % S;
      int s = 0, u = t;
      while (u >= tiles[s]) u -= tiles[s++];
      if (s != src_s) {                // a new source: its row offsets
        src_s = s;
        A = (const T*)g.a[s] + z * g.za;
        W = (const T*)g.w[s] + z * g.zw;
        if constexpr (kF32) Wl = (const T*)g.w_lo[s] + z * g.zw;
        if constexpr (!kAl) {
          al_a = al16(A) && g.lda[s] % E == 0 && k_lo[s] % E == 0;
          al_w = al16(W) && (!kF32 || al16(Wl)) && g.ldw[s] % E == 0 &&
                 k_lo[s] % E == 0;
        }
#pragma unroll
        for (int j = 0; j < 4 * NC; ++j) {
          const int r = r0 + 16 * j;
          na[j] = m0 + r < g.M;
          oa[j] = na[j] ? (long long)(m0 + r) * g.lda[s] : 0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + 16 * j;
          nw[j] = n0 + r < g.N;
          ow[j] = nw[j] ? (long long)(n0 + r) * g.ldw[s] : 0;
        }
      }
      const int gk = k_lo[s] + u * C::kBK + c * E;
      const int kn = min(max(k_hi[s] - gk, 0), E);   // real elements
      T* sa = ring + (size_t)st * C::kStage;
      T* sw = sa + C::kParts * kA;
      mbar_wait(&empty[st], ((t / S) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < 4 * NC; ++j) {
        const int r = r0 + 16 * j;
        const int at = r * C::kBK + ((c ^ (r & 7)) * E);
        load_chunk(sa + at, A + oa[j], gk, na[j] ? kn : 0, al_a);
        if (j < 4) {
          load_chunk(sw + at, W + ow[j], gk, nw[j] ? kn : 0, al_w);
          if constexpr (kF32)
            load_chunk(sw + C::kTile + at, Wl + ow[j], gk, nw[j] ? kn : 0,
                       al_w);
        }
      }
      if constexpr (kAl) {
        cp_async_mbar_arrive(&full[st]);
      } else {
        cp_async_mbar_track(&full[st]);
        if (!(al_a && al_w)) fence_proxy_async();   // element stores
        mbar_arrive(&full[st]);
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- the consumer warpgroups: wg takes rows 64 wg .. 64 wg + 63 ----
  const int wg = tid / kTcThreads, ct = tid % kTcThreads;
  float d[32], dt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  for (int t = 0; t < total; ++t) {
    const int st = t % S;
    mbar_wait(&full[st], (t / S) & 1);
    T* sa = ring + (size_t)st * C::kStage + wg * C::kTile;
    const T* sw = ring + (size_t)st * C::kStage + C::kParts * kA;
    if constexpr (kF32) {               // A's hi part in place, lo beside
      float4* a4 = (float4*)sa;
      float4* l4 = (float4*)(sa + kA);
      for (int i = ct; i < C::kTile / 4; i += kTcThreads) {
        const float4 x = a4[i];
        float4 h, l;
        h.x = tf32_round(x.x); l.x = tf32_round(x.x - h.x);
        h.y = tf32_round(x.y); l.y = tf32_round(x.y - h.y);
        h.z = tf32_round(x.z); l.z = tf32_round(x.z - h.z);
        h.w = tf32_round(x.w); l.w = tf32_round(x.w - h.w);
        a4[i] = h;
        l4[i] = l;
      }
    }
    fence_proxy_async();
    consumer_sync(wg);
#pragma unroll
    for (int i = 0; i < 32; ++i) dt[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < C::kSteps; ++k) {
      const int o = k * 32 / (int)sizeof(T);   // 32 bytes of K a step
      const uint64_t ah = wgmma_desc(sa + o);
      const uint64_t wh = wgmma_desc(sw + o);
      if constexpr (kF32) {
        const uint64_t al = wgmma_desc(sa + kA + o);
        const uint64_t wl = wgmma_desc(sw + C::kTile + o);
        wgmma_64x64<T>(dt, al, wh);
        wgmma_64x64<T>(dt, ah, wl);
      }
      wgmma_64x64<T>(dt, ah, wh);
    }
    wgmma_commit();
    wgmma_wait_all(dt);
    mbar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] += dt[i];
  }

  // accumulator j*4 + i of thread (warp w, lane l): row 16 w + l / 4 (+8
  // for i >= 2), column 8 j + 2 (l % 4) + i % 2
  const int warp = (ct >> 5), lane = ct & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + 64 * wg + 16 * warp + lane / 4 + (i >= 2 ? 8 : 0);
      const int gn = n0 + 8 * j + 2 * (lane % 4) + (i & 1);
      if (gm >= g.M || gn >= g.N) continue;
      if (g.ksplit == 1)
        epilogue<T>(g, z, gm, gn, d[j * 4 + i]);
      else
        g.part[(((long long)ks * g.nz + z) * g.M + gm) * g.N + gn] =
            d[j * 4 + i];
    }
  }
}

// Whether every source row of g is 16-byte aligned: A and W (and w_lo)
// pointers, their row strides, z-offsets and every K a multiple of 16
// bytes (so each source's slice starts on a chunk).
template <typename T>
static bool tc_aligned(const GemmArgs& g) {
  constexpr int E = Tc<T>::kEpc;
  auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  for (int s = 0; s < 3; ++s) {
    if (g.a[s] == nullptr) continue;
    if (g.k[s] % E || g.lda[s] % E || g.ldw[s] % E || g.za % E ||
        g.zw % E || !al(g.a[s]) || !al(g.w[s]) ||
        (sizeof(T) == 4 && !al(g.w_lo[s])))
      return false;
  }
  return true;
}

// gemm.cuh launch_gemm's contract on the tensor cores, for packed W only
// (wt = 1, and w_lo at float32); the split-K rule and the ordered reduce
// are launch_tiles' (two blocks per SM, at least four K tiles a slice,
// the partials within part_cap floats).
template <typename T>
static int launch_gemm_tc(GemmArgs g, int nz, cudaStream_t stream) {
  if (g.M < 1 || g.N < 1 || nz < 1 || g.epi < 0 || g.epi > kEpiF32Mul ||
      (g.aux2 != nullptr && g.aux2_div < 1))
    return (int)cudaErrorInvalidValue;
  int ktot = 0;
  for (int s = 0; s < 3; ++s) {
    if (g.a[s] == nullptr) continue;
    if (!g.wt[s] || (sizeof(T) == 4 && g.w_lo[s] == nullptr))
      return (int)cudaErrorInvalidValue;
    ktot += g.k[s];
  }
  constexpr int bm = Tc<T>::kBM;
  const int tiles = ((g.N + kTcBN - 1) / kTcBN) * ((g.M + bm - 1) / bm) * nz;
  int ksplit = 1;
  if (g.part != nullptr && tiles < 2 * kSms) {
    ksplit = std::min((2 * kSms + tiles - 1) / tiles,
                      std::max(ktot / (4 * Tc<T>::kBK), 1));
    const long long per_split = (long long)nz * g.M * g.N;
    ksplit = (int)std::min((long long)ksplit,
                           std::max(g.part_cap / per_split, 1LL));
  }
  g.nz = nz;
  constexpr int bk = Tc<T>::kBK;
  g.kchunk = (((ktot + ksplit - 1) / ksplit) + bk - 1) / bk * bk;
  g.ksplit = std::max((ktot + g.kchunk - 1) / g.kchunk, 1);
  const dim3 grid((g.N + kTcBN - 1) / kTcBN, (g.M + bm - 1) / bm,
                  nz * g.ksplit);
  constexpr size_t smem = Tc<T>::kSmem;
  const auto kernel = tc_aligned<T>(g) ? gemm_tc_kernel<T, true>
                                       : gemm_tc_kernel<T, false>;
  int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, Tc<T>::kThreads, smem, stream>>>(g);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ++tc_launches;
  if (g.ksplit == 1) return 0;
  const long long n = (long long)nz * g.M * g.N;
  const int blocks = (int)std::min((n + 255) / 256, 8LL * kSms);
  gemm_reduce_kernel<T><<<blocks, 256, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace iic
