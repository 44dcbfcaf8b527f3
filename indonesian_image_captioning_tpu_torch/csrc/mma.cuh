// The tensor-core GEMM of the decode step chain (span.cu: kernel 7;
// step.cu: the card tests' and chip_smoke.py's iic_gemm), of the train
// scan's pass A (train.cu) and of the latent-attention decoder's dense
// products (lm.cu), with gemm.cuh's contract:
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
// The products run on Hopper's tensor cores, wgmma on sm_90a, K in tiles
// of 128 bytes (32 float32 or 64 bf16 values):
//
// - bfloat16: wgmma.m64nNk16 on bf16 operands, float32 sums, the
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
// reads free of bank conflicts.  Two kernels share that layout, the
// arithmetic above (the same K tiles in the same order, the same
// promotion, K never split within a tile's sum) and the epilogue;
// launch_gemm_tc picks one from the shape alone.
//
// The 64 x 64 kernel (gemm_tc_kernel), built for the serving shape of R =
// B * K = 160 rows: one block an output tile of 64 x 64 (float32: 128 x
// 64), a producer warpgroup keeping a ring of stages full by cp.async
// ("full" mbarrier when a stage's copies landed, "empty" when its products
// are done) and kNC consumer warpgroups (64 rows each) that split A at
// float32 and run the wgmma, waiting for each K tile's products before
// the promotion.  A chunk is one 16-byte cp.async where its source row is
// 16-byte aligned (every chain shape), else eight or four element loads
// (a width that is not a multiple of 16 bytes, as the card tests' ragged
// shapes are); a ragged edge is filled with zeros.  A product with fewer
// output tiles than two per SM splits K over blocks, as gemm.cuh does.
// What bounds it at R = 160: operations, ~17.6 GFLOP per kernel-7 call of
// four SCN steps, three times over at float32 (3xTF32 at 495 TFLOP/s:
// 0.107 ms; bf16 at 989: 0.018 ms); what holds it back is the loads, not
// the tensor cores: with the wgmma removed it runs about as long
// (PERF.md), since every block reads its A tile again and W once per row
// tile.
//
// A third kernel, the persistent kernel's grouped mode
// (gemm_tc_grouped_kernel, at the end of this file), runs its tiles, ring
// and products over the per-expert row blocks of lm.cu's mixture of
// experts; it leaves the two kernels here as they were.
//
// The persistent kernel (gemm_tc_persistent_kernel), built for many rows
// at bf16: the chain at R = 10,240 (B = 2,048, beam 5), whose six SCN
// products a step (dec 512 x 512, the gate and hfac 2,048 x 512, xfac
// 2,048 x 2,560, the four gates 4 x 512 x 1,024, the head 6,763 x 512)
// are 2 R 13.2 M = 270 GFLOP, 0.27 ms at 989 TFLOP/s; their bytes (the
// rows in and out, the head's float32 logits 277 MB of them) take about
// 0.25 ms at 3.35 TB/s.  So operations bound it, with the bytes close
// behind.  The 64 x 64 kernel ran these at about 66 TFLOP/s (3.6 ms a
// step on the H100): its narrow tiles read A and W again and again, and
// each K tile's wait and each tile's epilogue left the tensor cores idle.
// Here one block an SM walks the 128 x 128 output tiles of every z-slice
// (the N tiles of a band of rows in turn, so the band of A stays in L2
// while W is read again from it); one producer thread brings A and W
// tiles by TMA (a 3-D tensor map a source and operand, (k, z, row) and
// (k, n, z), zeros past the edges) into a ring of kPsStages stages, which
// it keeps filling through the epilogue; two consumer warpgroups of 64
// rows run wgmma.m64n128k16.  Before a tile's products a consumer thread
// loads what its share of the epilogue reads (aux and the biases), so
// those loads run under the products; after them the sums go through
// shared memory, half a tile at a time, so that each thread finishes four
// neighbouring outputs of a row with one vector store.  The epilogue runs
// as one instance per epilogue code: with the code switched per output,
// the fully unrolled epilogue was 68,000 instructions and ran from the
// instruction cache's misses.  Measured (PERF.md, H100): the six
// products in 0.95 ms a step, of which the products alone about 0.38 (630-
// 690 TFLOP/s where K is 2,560 or more); the rest is the epilogue's
// arithmetic and stores, which the products do not overlap.
#pragma once

#include <cstdint>
#include <mutex>
#include <type_traits>

#include <cuda.h>

#include "gemm.cuh"

namespace iic {

// Host-side counts of launch_gemm_tc's GEMM launches in this library, and
// of those that took the persistent kernel.
inline int tc_launches = 0;
inline int tc_persistent_launches = 0;

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
// Keeps the compiler from moving reads or writes of d's R registers across
// this point (the wgmma groups own them in between).
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Until every wgmma group is done; d's R registers are then readable.
template <int R = 32>
__device__ __forceinline__ void wgmma_wait_all(float* d) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs<R>(d);
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

// ------------------------------------------------- the persistent path ----

// bf16: a K tile of 64 values (128 bytes), 128 x 128 outputs a tile, two
// consumer warpgroups of 64 rows and a producer warpgroup, a ring of
// kPsStages stages of an A and a W tile (32 KB each).
constexpr int kPsBM = 128, kPsBN = 128, kPsBK = 64;
constexpr int kPsStages = 5;
constexpr int kPsThreads = 3 * kTcThreads;
constexpr int kPsA = kPsBM * kPsBK, kPsW = kPsBN * kPsBK;   // elements
constexpr int kPsStageBytes = 2 * (kPsA + kPsW);
// The epilogue's staging: a consumer warpgroup's sums, 64 rows x 64
// columns (half a tile) at a time, rows kPsLd floats apart (8 of padding:
// the accumulators' 8-byte stores, four rows a half-warp, hit 32 banks).
constexpr int kPsLd = 72;
constexpr int kPsStageF = 64 * kPsLd;
constexpr size_t kPsSmem = (size_t)kPsStages * kPsStageBytes +
                           2 * sizeof(float) * kPsStageF + 16 * kPsStages +
                           1024;
static_assert(kPsSmem <= 232448, "a block's shared memory");
constexpr int kPsMaps = 128;   // tensor maps the launcher keeps

// The persistent kernel's tensor maps: source s's A as (k, z, row) and its
// W as (k, n, z), bf16, 128-byte swizzle, zeros past every edge.
struct PsMaps {
  CUtensorMap a[3];
  CUtensorMap w[3];
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), reached through the runtime's
// entry-point query, so the library links no libcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)f;
  }
  return fn;
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One tile by TMA: the box at {c0, c1, c2} of map into dst; bar receives
// the bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// mbar_wait with a bound, for the persistent kernel: a wait past 2^34
// cycles (about 9 s; a product takes under a millisecond) is a fault, a
// lost arrival, and traps rather than hold the card.
__device__ __forceinline__ void ps_wait(uint64_t* bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

#define IIC_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define IIC_D64_OUT(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128, float32) = A (64 x 16) . B (128 x 16)^T (+ d where acc),
// both K-major bf16.
__device__ __forceinline__ void wgmma_64x128(float* d, uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " IIC_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : IIC_D64_OUT(d)
      : "l"(da), "l"(db), "r"(acc));
}

// The products of ring tile i (stage i % kPsStages) into fresh registers
// acc: consumer warpgroup cw's 64 rows of A against the 128 rows of W,
// four k16 steps, one commit group.
__device__ __forceinline__ void ps_issue(float* acc,
                                         const __nv_bfloat16* ring,
                                         uint64_t* full, int cw, int i) {
  const int st = i % kPsStages;
  ps_wait(&full[st], (i / kPsStages) & 1);
  const __nv_bfloat16* sa = ring + (size_t)st * (kPsA + kPsW) + cw * 64 * kPsBK;
  const __nv_bfloat16* sw = ring + (size_t)st * (kPsA + kPsW) + kPsA;
  fence_regs<64>(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)   // 16 values (32 bytes) of K a step
    wgmma_64x128(acc, wgmma_desc(sa + 16 * k), wgmma_desc(sw + 16 * k), k);
  wgmma_commit();
  fence_regs<64>(acc);
}

// Ring tile i's sums, done in acc: its stage goes back to the producer
// (a warp's lane 0 arrives) and the sums into the accumulator d.
__device__ __forceinline__ void ps_retire(float* d, const float* acc,
                                          uint64_t* empty, int lane, int i) {
  if (lane == 0) mbar_arrive(&empty[i % kPsStages]);
#pragma unroll
  for (int j = 0; j < 64; ++j) d[j] += acc[j];
}

// Four bf16 at p (n of them, zeros after) in a uint2: one 8-byte load
// where p is aligned for it and n = 4.
__device__ __forceinline__ uint2 ld4_bf16(const __nv_bfloat16* p, int n) {
  if (n == 4 && (uintptr_t)p % 8 == 0) return __ldg((const uint2*)p);
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < n) v[k] = __bfloat16_as_ushort(__ldg(p + k));
  return make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
}

// bf16 k of q (ld4_bf16) as a float.
__device__ __forceinline__ float bf16_at(uint2 q, int k) {
  const uint32_t w = k < 2 ? q.x : q.y;
  return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
}

// What a consumer thread's epilogue reads of aux and the biases: for half
// h of the tile's columns, its columns gn = n0 + 64 h + 4 (t % 16) .. + 3
// of the biases, and of aux in rows m0 + t / 16 + 8 i (t the thread of the
// warpgroup).  ps_prefetch loads them before the tile's products, so that
// the loads run under the products.
struct PsIn {
  uint2 aux[2][8];
  uint2 b1[2], b2[2];
};

__device__ __forceinline__ void ps_prefetch(const GemmArgs& g, PsIn& in,
                                            int z, int m0, int n0) {
  using T = __nv_bfloat16;
  const int e = g.epi, ct = threadIdx.x % kTcThreads;
  const int rr = ct / 16, rc = 4 * (ct % 16);
  const bool aux = g.aux && epi_reads_aux(e);
  const bool b1 = g.bias1 && epi_reads_bias1(e);
  const bool b2 = g.bias2 && e == kEpiPre;
  const uint2 zero = make_uint2(0, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gn = n0 + 64 * h + rc, n = min(g.N - gn, 4);
    in.b1[h] = b1 && n > 0
                   ? ld4_bf16((const T*)g.bias1 + z * g.zb + gn, n) : zero;
    in.b2[h] = b2 && n > 0
                   ? ld4_bf16((const T*)g.bias2 + z * g.zb + gn, n) : zero;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + rr + 8 * i;
      in.aux[h][i] =
          aux && n > 0 && gm < g.M
              ? ld4_bf16((const T*)g.aux + z * g.zc + gm * g.ldaux + gn, n)
              : zero;
    }
  }
}

// Epilogue E on consumer warpgroup cw's 64 x 128 sums d of a tile, rows
// m0 .., columns n0 .., with what ps_prefetch loaded: each half of the
// columns goes through the staging st (accumulator j*4 + i of thread
// (warp w, lane l) is row 16 w + l / 4 (+8 for i >= 2), column 8 j + 2 (l
// % 4) + i % 2), then a thread finishes four neighbouring columns of every
// eighth row, so that a warp's stores run along rows.  One instance an
// epilogue code: a launch runs the code of its own.
template <int E>
__device__ __forceinline__ void ps_epilogue(const GemmArgs& g, const float* d,
                                            const PsIn& in, float* st, int cw,
                                            int z, int m0, int n0) {
  using T = __nv_bfloat16;
  const int ct = threadIdx.x % kTcThreads, warp = ct >> 5, lane = ct & 31;
  const int wr = 16 * warp + lane / 4, wc = 2 * (lane % 4);
  const int rr = ct / 16, rc = 4 * (ct % 16);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    consumer_sync(cw);                 // the last half's reads are done
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* v = d + 4 * (8 * h + j);
      *(float2*)(st + wr * kPsLd + 8 * j + wc) = make_float2(v[0], v[1]);
      *(float2*)(st + (wr + 8) * kPsLd + 8 * j + wc) =
          make_float2(v[2], v[3]);
    }
    consumer_sync(cw);
    const int gn = n0 + 64 * h + rc, n = min(g.N - gn, 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rr + 8 * i, gm = m0 + r;
      const float4 v = *(const float4*)(st + r * kPsLd + rc);
      const float vs[4] = {v.x, v.y, v.z, v.w};
      if (gm >= g.M || n <= 0) continue;
      GemmIn x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k].b1 = bf16_at(in.b1[h], k);
        x[k].b2 = bf16_at(in.b2[h], k);
        x[k].aux = bf16_at(in.aux[h][i], k);
        x[k].aux2 = 0.0f;
        if (g.aux2 != nullptr && k < n) {   // the train scan's, per image
          const long long ai =
              (gm / g.aux2_div) * g.ldaux2 + z * g.zc + gn + k;
          x[k].aux2 = g.aux2_f32 ? __ldg((const float*)g.aux2 + ai)
                                 : to_f(__ldg((const T*)g.aux2 + ai));
        }
      }
      epilogue4<T, E>(g, z, gm, gn, vs, x, n);
    }
  }
}

// Each K tile's products are waited for before the tile's sums are added
// in: ptxas serialises wgmma groups whose accumulators are read between a
// group's start and its end, so two sets of registers in turn bought no
// overlap.
template <typename T>
__global__ void __launch_bounds__(kPsThreads, 1)
    gemm_tc_persistent_kernel(const __grid_constant__ GemmArgs g,
                              const __grid_constant__ PsMaps maps) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 only");
  constexpr int S = kPsStages;
  extern __shared__ __align__(1024) unsigned char ps_smem[];
  T* ring = (T*)(((uintptr_t)ps_smem + 1023) & ~(uintptr_t)1023);
  float* staging = (float*)(ring + (size_t)S * (kPsA + kPsW));
  uint64_t* full = (uint64_t*)(staging + 2 * kPsStageF);
  uint64_t* empty = full + S;
  // output tile `tile`: n fastest, then the row band, then z
  const int tn = (g.N + kPsBN - 1) / kPsBN;
  const int tm = (g.M + kPsBM - 1) / kPsBM;
  const int tiles = tn * tm * g.nz;
  int kt[3], total = 0;   // K tiles of each source, and of an output tile
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    kt[s] = g.a[s] == nullptr ? 0 : (g.k[s] + kPsBK - 1) / kPsBK;
    total += kt[s];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);      // the producer's expect_tx
      mbar_init(&empty[s], 8);     // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / kTcThreads;

  if (wg == 0) {
    // ---- the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nt = tile % tn, mt = (tile / tn) % tm, z = tile / (tn * tm);
      for (int s = 0; s < 3; ++s)
        for (int u = 0; u < kt[s]; ++u, ++it) {
          const int st = it % S;
          T* sa = ring + (size_t)st * (kPsA + kPsW);
          ps_wait(&empty[st], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[st], kPsStageBytes);
          tma_load_3d(sa, &maps.a[s], u * kPsBK, z, mt * kPsBM, &full[st]);
          tma_load_3d(sa + kPsA, &maps.w[s], u * kPsBK, nt * kPsBN, z,
                      &full[st]);
        }
    }
    return;
  }

  // ---- the consumers: warpgroup cw takes rows 64 cw .. 64 cw + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, lane = threadIdx.x & 31;
  float* st = staging + cw * kPsStageF;
  float d[64], t[64];
  PsIn in;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nt = tile % tn, mt = (tile / tn) % tm, z = tile / (tn * tm);
    const int m0 = mt * kPsBM + 64 * cw, n0 = nt * kPsBN;
    ps_prefetch(g, in, z, m0, n0);
#pragma unroll
    for (int j = 0; j < 64; ++j) d[j] = 0.0f;
    for (int j = 0; j < total; ++j, ++it) {
      ps_issue(t, ring, full, cw, it);
      wgmma_wait_all<64>(t);
      ps_retire(d, t, empty, lane, it);
    }
    switch (g.epi) {   // launch_gemm_tc checked the code
      case kEpiBias: ps_epilogue<kEpiBias>(g, d, in, st, cw, z, m0, n0);
        break;
      case kEpiPre: ps_epilogue<kEpiPre>(g, d, in, st, cw, z, m0, n0);
        break;
      case kEpiSigmoidMul:
        ps_epilogue<kEpiSigmoidMul>(g, d, in, st, cw, z, m0, n0);
        break;
      case kEpiMul: ps_epilogue<kEpiMul>(g, d, in, st, cw, z, m0, n0);
        break;
      case kEpiAddMul:
        ps_epilogue<kEpiAddMul>(g, d, in, st, cw, z, m0, n0);
        break;
      case kEpiGate: ps_epilogue<kEpiGate>(g, d, in, st, cw, z, m0, n0);
        break;
      case kEpiRawMul:
        ps_epilogue<kEpiRawMul>(g, d, in, st, cw, z, m0, n0);
        break;
      case kEpiFacBwd:
        ps_epilogue<kEpiFacBwd>(g, d, in, st, cw, z, m0, n0);
        break;
      case kEpiGateBwd:
        ps_epilogue<kEpiGateBwd>(g, d, in, st, cw, z, m0, n0);
        break;
      default: ps_epilogue<kEpiF32Mul>(g, d, in, st, cw, z, m0, n0);
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

// A 3-D tensor map of the bf16 values at p: dims (d0, d1, d2), the byte
// strides s1 and s2 of dims 1 and 2, boxes of (kPsBK, b1, b2).  The last
// kPsMaps are kept: a chain's sources and weights are the same tensors at
// every step.
static int ps_map(CUtensorMap* map, const void* p, cuuint64_t d0,
                  cuuint64_t d1, cuuint64_t d2, cuuint64_t s1, cuuint64_t s2,
                  cuuint32_t b1, cuuint32_t b2) {
  struct Entry {
    const void* p;
    cuuint64_t key[7];
    CUtensorMap map;
  };
  static Entry cache[kPsMaps];
  static int next = 0;
  static std::mutex mu;
  const cuuint64_t key[7] = {d0, d1, d2, s1, s2, b1, b2};
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.p == p && std::equal(key, key + 7, e.key)) {
      *map = e.map;
      return 0;
    }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {(cuuint32_t)kPsBK, b1, b2};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, (void*)p, dims,
             strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  Entry& e = cache[next];
  e.p = p;
  std::copy(key, key + 7, e.key);
  e.map = *map;
  next = (next + 1) % kPsMaps;
  return 0;
}

// The output tiles of the persistent kernel.
static long long ps_tiles(const GemmArgs& g, int nz) {
  return (long long)((g.N + kPsBN - 1) / kPsBN) *
         ((g.M + kPsBM - 1) / kPsBM) * nz;
}

// The persistent kernel on a bf16 product whose sources tc_aligned
// passes, unsplit.  A's map is (k, z, row) with z's stride za (row's
// where nz = 1, a dim of one); W's (k, n, z) with z's stride zw (n's
// times N where nz = 1).
static int launch_persistent(GemmArgs g, int nz, cudaStream_t stream) {
  constexpr cuuint64_t e = sizeof(__nv_bfloat16);
  PsMaps maps = {};
  for (int s = 0; s < 3; ++s) {
    if (g.a[s] == nullptr) continue;
    const cuuint64_t k = g.k[s], lda = g.lda[s] * e, ldw = g.ldw[s] * e;
    int err = ps_map(&maps.a[s], g.a[s], k, nz, g.M,
                     nz > 1 ? g.za * e : lda, lda, 1, kPsBM);
    if (err != 0) return err;
    err = ps_map(&maps.w[s], g.w[s], k, g.N, nz, ldw,
                 nz > 1 ? g.zw * e : ldw * g.N, kPsBN, 1);
    if (err != 0) return err;
  }
  g.nz = nz;
  g.ksplit = 1;
  g.kchunk = 0;
  const auto kernel = gemm_tc_persistent_kernel<__nv_bfloat16>;
  int err = allow_smem(kernel, kPsSmem);
  if (err != 0) return err;
  const int grid = (int)std::min(ps_tiles(g, nz), (long long)kSms);
  kernel<<<grid, kPsThreads, kPsSmem, stream>>>(g, maps);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ++tc_launches;
  ++tc_persistent_launches;
  return 0;
}

// gemm.cuh launch_gemm's contract on the tensor cores, for packed W only
// (wt = 1, and w_lo at float32).  The rule, from the shape alone: a bf16
// product whose sources tc_aligned passes and whose 128 x 128 output
// tiles fill the card at least once (kSms) runs on the persistent
// kernel; every other on the 64 x 64 kernel, whose split-K rule and
// ordered reduce are launch_tiles' (two blocks per SM, at least four K
// tiles a slice, the partials within part_cap floats).  tiles_only keeps
// a product on the 64 x 64 kernel: the yardstick that the card tests and
// chip_smoke.py hold the persistent kernel against (iic_gemm_args).
template <typename T>
static int launch_gemm_tc(GemmArgs g, int nz, cudaStream_t stream,
                          bool tiles_only = false) {
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
  const bool aligned = tc_aligned<T>(g);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (!tiles_only && aligned && ps_tiles(g, nz) >= kSms)
      return launch_persistent(g, nz, stream);
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
  const auto kernel = aligned ? gemm_tc_kernel<T, true>
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

// ------------------------------------------------ the grouped mode ----
//
// The persistent kernel's products for a mixture of experts (lm.cu): the
// rows of every expert group lie in one tensor A (rows, K), each group's
// block padded to 128 rows (the dispatch's counting sort), and group g's
// weights are W[g] (N, K), stacked (G, N, K).  Row tile mt (128 rows) is
// group tile_group[mt]'s, its live rows below tile_end[mt]; ntiles (on the
// device) says how many row tiles the dispatch filled, so the launch needs
// no copy home.  The tiles, the ring, the producer's TMA loads (W's map
// (k, n, group)), the consumers' wgmma.m64n128k16 and the promotion of
// each K tile are the persistent kernel's own (ps_issue, ps_retire);
// only the tile walk and the epilogue differ, and the persistent kernel
// above is left as it was.  Epilogues, from the accumulators in registers:
//
//   kGroupedSwiGlu  W's rows interleave gate and up (row 2j the gate's j,
//                   2j + 1 the up's j), so each thread holds both halves
//                   of its outputs: C[row, j] = bf16(silu(gate) * up),
//                   from the float32 sums, C (rows, N / 2);
//   kGroupedScale   C[row, n] = sum * scale[row], float32 (the routing
//                   weight of the row's (token, expert) pair).
//
// K a multiple of 64 and N of 128 (the launcher refuses others).
constexpr int kGroupedSwiGlu = 0, kGroupedScale = 1;

struct GroupedArgs {
  const void* a;          // bf16 (rows, lda)
  const void* w;          // bf16 (G, N, K)
  void* c;                // see the epilogues
  long long ldc;
  const float* scale;     // (rows,) kGroupedScale's
  const int* tile_group;  // (max_tiles,) the group of a row tile
  const int* tile_end;    // (max_tiles,) the end of its live rows
  const int* ntiles;      // (1,) row tiles filled
  int K, N;
};

constexpr size_t kGsSmem =
    (size_t)kPsStages * kPsStageBytes + 16 * kPsStages + 1024;

template <int kEpi>
__global__ void __launch_bounds__(kPsThreads, 1)
    gemm_tc_grouped_kernel(const __grid_constant__ GroupedArgs g,
                           const __grid_constant__ PsMaps maps) {
  using T = __nv_bfloat16;
  constexpr int S = kPsStages;
  extern __shared__ __align__(1024) unsigned char ps_smem[];
  T* ring = (T*)(((uintptr_t)ps_smem + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(ring + (size_t)S * (kPsA + kPsW));
  uint64_t* empty = full + S;
  const int tn = g.N / kPsBN;
  const int tiles = __ldg(g.ntiles) * tn;   // n fastest, then row tiles
  const int kt = g.K / kPsBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / kTcThreads;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nt = tile % tn, mt = tile / tn;
      const int grp = __ldg(g.tile_group + mt);
      for (int u = 0; u < kt; ++u, ++it) {
        const int st = it % S;
        T* sa = ring + (size_t)st * (kPsA + kPsW);
        ps_wait(&empty[st], ((it / S) & 1) ^ 1);
        mbar_expect_tx(&full[st], kPsStageBytes);
        tma_load_3d(sa, &maps.a[0], u * kPsBK, 0, mt * kPsBM, &full[st]);
        tma_load_3d(sa + kPsA, &maps.w[0], u * kPsBK, nt * kPsBN, grp,
                    &full[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, lane = threadIdx.x & 31;
  const int warp = (threadIdx.x % kTcThreads) >> 5;
  float d[64], t[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nt = tile % tn, mt = tile / tn;
    const int end = __ldg(g.tile_end + mt);
#pragma unroll
    for (int j = 0; j < 64; ++j) d[j] = 0.0f;
    for (int j = 0; j < kt; ++j, ++it) {
      ps_issue(t, ring, full, cw, it);
      wgmma_wait_all<64>(t);
      ps_retire(d, t, empty, lane, it);
    }
    // accumulator 4 j + i: row 16 warp + lane / 4 (+ 8 for i >= 2),
    // column 8 j + 2 (lane % 4) + i % 2 of the warpgroup's 64 x 128
    const int r0 = mt * kPsBM + 64 * cw + 16 * warp + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= end) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = nt * kPsBN + 8 * j + 2 * (lane % 4);
        const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
        if constexpr (kEpi == kGroupedSwiGlu) {
          ((T*)g.c)[row * g.ldc + col / 2] =
              __float2bfloat16(v0 / (1.0f + expf(-v0)) * v1);
        } else {
          const float s = __ldg(g.scale + row);
          *(float2*)((float*)g.c + row * g.ldc + col) =
              make_float2(v0 * s, v1 * s);
        }
      }
    }
  }
}

// The grouped mode on rows a (rows, lda) of the dispatch's blocks, W (G,
// N, K), max_tiles the row tiles a may hold.  Returns the launch's CUDA
// error code.
static int launch_grouped(const GroupedArgs& g, long long lda, int rows,
                          int G, int max_tiles, int epi,
                          cudaStream_t stream) {
  if (g.K % kPsBK || g.N % kPsBN || lda % 8 || rows < kPsBM ||
      max_tiles < 1 || (epi != kGroupedSwiGlu && epi != kGroupedScale) ||
      (uintptr_t)g.a % 16 || (uintptr_t)g.w % 16)
    return (int)cudaErrorInvalidValue;
  constexpr cuuint64_t e = sizeof(__nv_bfloat16);
  PsMaps maps = {};
  int err = ps_map(&maps.a[0], g.a, g.K, 1, rows, lda * e, lda * e, 1,
                   kPsBM);
  if (err != 0) return err;
  err = ps_map(&maps.w[0], g.w, g.K, g.N, G, g.K * e,
               (cuuint64_t)g.N * g.K * e, kPsBN, 1);
  if (err != 0) return err;
  const auto kernel = epi == kGroupedSwiGlu
                          ? gemm_tc_grouped_kernel<kGroupedSwiGlu>
                          : gemm_tc_grouped_kernel<kGroupedScale>;
  err = allow_smem(kernel, kGsSmem);
  if (err != 0) return err;
  const long long tiles = (long long)max_tiles * (g.N / kPsBN);
  const int grid = (int)std::min(tiles, (long long)kSms);
  kernel<<<grid, kPsThreads, kGsSmem, stream>>>(g, maps);
  return (int)cudaGetLastError();
}

}  // namespace iic
