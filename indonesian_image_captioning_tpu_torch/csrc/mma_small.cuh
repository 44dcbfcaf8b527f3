// The tensor-core GEMM of the per-step products of few rows: the train
// scan's (train.cu, the batch of a train step, B = 32 images) and the
// fused decode step's (step.cu, the beam batch, R = B*K rows).
//
//   out[b, r] = epilogue(sum_s X_s[b, :] . W_s[r, :])
//
// computed transposed ("swap-AB"): the weight's output rows fill wgmma's
// 64-row M side and the batch is wgmma's N.  A block's batch tile is NB
// rows (a ragged batch is masked, a larger one takes more batch tiles):
// NB = 32 (kSmN), one warpgroup at n = 32, for the train scan; NB = 160
// (kSmWide), two consumer warpgroups at n = 80 that share every W tile,
// for the decode step, whose whole beam batch (R = 160 at B = 32, K = 5)
// is then one batch tile, so each W tile is read from device memory once
// a step.  Both operands are K-major in shared memory, in mma.cuh's
// 128-byte swizzle: W as stored
// (rows, K) -- a forward weight packed so by ops/train_cuda.py, a
// backward weight x @ W^T read in its own (in, out) layout -- and X as the
// activations' rows.  Up to three K segments (sources) add into one sum;
// kSmStepGather reads source 0's rows through a row index (the megakernel's
// embedding rows by the previous words).  A launch given an early-exit
// word (SmallLaunch::live) returns at once when the word is 0.
//
// - float32: 3xTF32, as mma.cuh: each operand is split into TF32 hi and lo
//   parts and C sums lo.hi + hi.lo + hi.hi (wgmma.m64nNk8), here with hi
//   truncated rather than rounded: hi is x itself, which the tensor cores
//   read as TF32 by dropping its 13 low mantissa bits, so lo = x - hi is
//   exact and only lo is written.  The error is about 3 x 2^-20 of sum
//   |x||w|, within the 1e-5 the tensor-core GEMMs are held to, but it
//   leans one way (lo has x's sign, so every term shrinks a little).  The
//   decode's vocab head (kSmLogits) rounds hi instead: hi = x rounded to
//   TF32 (ties away, as cvt.rna, in two integer operations) written back
//   over x, lo = x - hi, which has either sign, so the error, about 2^-21
//   of sum |x||w|, does not lean -- kernel 13 adds 51 steps'
//   log-probabilities, and the truncated head's lean reached 1.5e-4 in
//   its scores, over its 1e-4.  W comes from device memory once, as
//   float32, and is split in shared memory: a pre-split W would double
//   the bytes that every step reads again.
// - bfloat16: wgmma.m64nNk16 on bf16 operands.
// - Each K tile's tensor-core sums go into fresh registers and are added
//   to the float32 accumulator after the tile (mma.cuh, "per-K-tile
//   promotion"): it keeps the 51-step recurrences within float32's
//   tolerances.
//
// Sm<T, NB>::kWG warpgroups a block; a block owns one 64-row tile of W,
// one NB-row batch tile and one slice of K.  Tiles land in a ring of
// Sm::kStages: W by TMA (one thread, a tensor map per weight, the
// hardware's 128-byte swizzle, an mbarrier a stage) under an L2
// evict-last policy -- the scan's weights, 35 MB at float32, are read
// again every step and fit the 50 MB L2, while the encoder state streams
// past them with evict-first loads in train.cu; the decode step's 52.7 MB
// do not fit, and another policy measured the same -- and X by cp.async.
// One barrier a tile; six stages, four tiles ahead: tile t's products
// run while the threads split tile t + 1 (wgmma.wait_group 1).  The wide
// tile at float32 instead waits for each tile's products before the next
// barrier (a read of a group in flight makes the compiler wait after
// every wgmma, so the tile's 12 products would run one at a time), and
// its ring runs five tiles ahead (28 KB stages, two lo buffers).
//
// Split-K in one launch: the K slices of an output tile -- and, with
// group = 4, the tiles of the four gates of the same 64 units -- are one
// thread-block cluster.  Each block leaves its sums in its shared memory;
// after a cluster barrier every block of the cluster adds, through
// distributed shared memory, the slices of a share of the outputs in slice
// order (so the sum does not depend on which block ran first) and runs the
// epilogue on that share.  So a gate group's blocks finish the cell
// together, and no partial goes through device memory.  One launch may
// carry two products of one cluster shape (kSmProbs).  A wide block fills
// its SM, so the launcher cuts the split until every cluster is resident
// at once (cudaOccupancyMaxActiveClusters).
//
// What bounds it at the scan's shapes (PERF.md): not the operations
// and not the bytes at the card's rates.  A launch costs about 6-7 us
// however small its product (the ring's fill, the cluster barriers, the
// epilogue's loads), and the W stream then runs at about 2 TB/s from L2;
// a float32 product costs 2-3 times its bfloat16 twin (twice the tiles,
// three products a tile, the lo split).  At the decode step's (PERF.md,
// the step chain's findings): about 4 us a launch before its first tile,
// 3-26 us of epilogue (more with a cluster's slices and the epilogue's
// own loads), then about 1 us a K tile at bfloat16 and 2 at float32
// however few the batch rows -- the per-tile code, not the bytes.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda.h>

#include "mma.cuh"

namespace iic {

constexpr int kSmM = 64, kSmN = 32, kSmThreads = 128, kSmStages = 6;
constexpr int kSmWide = 160;          // the decode step's batch tile
constexpr int kSmProbs = 2;

// The shape of a block of batch tile NB (kSmN or kSmWide).
template <typename T, int NB = kSmN>
struct Sm {
  static constexpr int kBK = 128 / sizeof(T);   // K of a tile: 128 bytes
  static constexpr int kEpc = 16 / sizeof(T);
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWG = NB > kSmN ? 2 : 1;  // consumer warpgroups
  static constexpr int kNW = NB / kWG;           // batch rows of one: its n
  static constexpr int kThreads = kWG * kSmThreads;
  // the ring: the wide float32 tile waits for each tile's products before
  // the next tile's barrier (kWait), so its loads run a stage further
  // ahead and two lo buffers do (see the K loop)
  static constexpr bool kWait = NB > kSmN && kF32;
  static constexpr int kStages = kSmStages;
  static constexpr int kAhead = kWait ? kStages - 1 : kStages - 2;
  static constexpr int kLo = kF32 ? (kWait ? 2 : 3) : 0;
  static constexpr int kW = kSmM * kBK;          // elements of a W tile
  static constexpr int kX = NB * kBK;            // of an X tile
  static constexpr int kStage = kW + kX;        // a ring stage: W, X
  static constexpr int kWJ = kSmM * 8 / kThreads;   // 16-byte chunks a
  static constexpr int kXC = NB * 8 / kThreads;     // thread: W's, X's
  // the row stride of the block's sums in the epilogue: the wide tile's
  // padded by a float, so a warp's reads down a column hit 32 banks
  static constexpr int kLdr = NB > kSmN ? NB + 1 : NB;
  // blocks of a cluster, at most (a wide block fills its SM; clusters of
  // 12 and 16 such blocks measured no faster), and the blocks a launch
  // aims for
  static constexpr int kMaxCluster = NB > kSmN ? 8 : 16;
  static constexpr int kTarget = NB > kSmN ? kSms : 2 * kSms;
  // TMA descriptors kept by the launcher (a decode serves several trees)
  static constexpr int kMaps = NB > kSmN ? 64 : 16;
  // the ring, [3 x (W lo, X lo)]; 1024 bytes for the alignment
  static constexpr size_t kSmem =
      sizeof(T) * ((size_t)(kStages + kLo) * kStage) + 1024;
  static_assert(kNW % 8 == 0 && kNW <= 256, "wgmma takes n = 8 .. 256");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// Epilogues (SmallProb::epi); v is the float32 sum, r the output row of
// its z-slice (or the unit of a gate group), b the batch row.
enum SmallEpi {
  kSmHall = 0,     // r < n1: out = v + bias1[r]; r < n2: out = v + bias2[r -
                   // n1] (float32); then SCN out2 = rt(rt(v) aux[b, r - n2]),
                   // LSTM out2 = v (float32)
  kSmXfac = 1,     // out = rt(rt(rt(v) + aux[b, r]) aux2[b, r])
  kSmCell = 2,     // group 4: the gates' pre-activations, the cell -> h, c
  kSmFac = 3,      // col = z rows + r: acc[b, col] += v aux2[b, col];
                   // out = rt(v aux[b, col])
  kSmGateBwd = 4,  // g = aux2 (float32); out2 = rt(v g);
                   // out = rt(v aux g (1 - g))
  kSmDh = 5,       // n1 == 0: out = v (float32); else the cell backward of
                   // the step before, with dh = v
  kSmPlain = 6,    // out = v (float32): the GEMM alone (iic_small_gemm,
                   // iic_wide_gemm)
  // the decode step's (step.cu), rounding where the Pallas body casts:
  kSmStepIn = 7,   // r < n1: out = rt(rt(v) + bias1[r]) (dec); r < n2:
                   // out2 = rt(sigmoid(rt(rt(v) + bias2[r - n1]))) (the
                   // f_beta gate); else out3 = rt(rt(v) aux[b, r - n2])
                   // (hfac, 6b's xfac), or rt(v) without aux (xe)
  kSmStepCell = 8, // group 4: pre = rt(v + bias1) (float32, bx + bh), the
                   // cell on c = aux3 -> h (out), c (out2)
  kSmLogits = 9,   // out (float32) = rt(rt(v) + bias1[r])
  // the fused SCN cell (scn.cu), float32 up to one final cast:
  kSmF32Mul = 10,  // out (float32) = v aux[b, r], not rounded
  kSmScnCell = 11, // group 4: pre = v + bias1 (float32, b_x + b_h), the
                   // float32 cell on c = aux3 -> h (out), c (out2) in T
  kSmScnCellBf = 12,  // kSmScnCell at T = float with c, h, c' in bfloat16:
                      // X float32 (tx, th), W bfloat16 values held as
                      // float32, exact in TF32, so W has no lo part (2xTF32)
  kSmStepGather = 13, // kSmStepIn whose products may gather the rows of
                      // source 0 (xid): the megakernel's L1, emb @ wxe on
                      // the embedding rows of the previous words.  Its own
                      // instance: the row indices cost the others' loads
};

// The float32 product's W has a lo part (3xTF32); kSmScnCellBf's does not.
template <int EPI>
constexpr bool kSmWLo = EPI != kSmScnCellBf;

struct SmallProb {
  // the product: sources s < nsrc, K segments of the one sum
  CUtensorMap map[3];    // W's TMA descriptors (set by the launcher)
  const void* x[3];      // activations (batch rows, ldx), type T
  const void* w[3];      // weights: row R at w + R ldw, K-major, type T
  const int* xid;        // kSmStepGather: null, or row b of source 0 is
  int xid_rows;          //   row xid[b] of x[0], an id in [0, xid_rows)
  long long ldx[3], ldw[3];
  long long wrows[3];    // W's rows in its allocation (the TMA bound)
  int k[3];
  int w_al[3], x_al[3];  // set by the launcher: rows 16-byte aligned
  int nsrc;
  int rows;              // output rows of one z-slice
  int nz;                // z-slices (gates)
  int group;             // 1, or nz: the z-slices one epilogue sees
  long long zx;          // X column offset of a z-slice
  long long z_rows;      // W row offset of a z-slice
  long long lt_rows;     // W row offset of a 64-row tile within a slice
  // the epilogue
  int epi, n1, n2, lstm;
  const void* bias1;     // T (kSmCell: float32, bx + bh)
  const void* bias2;     // T
  const void* aux;       // T
  long long ldaux;
  const void* aux2;      // T, or float32 where aux2_f32
  long long ldaux2;
  int aux2_f32;
  const void* aux3;      // T
  long long ldaux3;
  const void* aux4;      // T
  long long ldaux4;
  void* out;             // T or float32, by epi
  long long ldo;
  void* out2;            // T or float32, by epi
  long long ldo2;
  void* out3;            // T (kSmStepIn)
  long long ldo3;
  float* acc;            // float32, read and written
  long long ldacc;
  // set by the launcher
  int ktiles, ksplit, tchunk, blocks;
};

struct SmallLaunch {
  SmallProb p[kSmProbs];
  int nprob;
  int B;                 // batch rows
  int cluster;           // blocks of a cluster (set by the launcher)
  const int* live;       // or null: every block returns when *live is 0
};

// The fields an epilogue reads, copied out of the kernel's parameter into
// registers by the wide tile: read through the parameter's generic address,
// they would be loaded again after every store the compiler cannot prove
// apart from them.
struct EpiP {
  int n1, n2, lstm, rows, aux2_f32;
  const void *bias1, *bias2, *aux, *aux2, *aux3, *aux4;
  long long ldaux, ldaux2, ldaux3, ldaux4, ldo, ldo2, ldo3, ldacc;
  void *out, *out2, *out3;
  float* acc;
};

__device__ __forceinline__ EpiP epi_params(const SmallProb& P) {
  return {P.n1,    P.n2,     P.lstm,   P.rows,   P.aux2_f32, P.bias1,
          P.bias2, P.aux,    P.aux2,   P.aux3,   P.aux4,     P.ldaux,
          P.ldaux2, P.ldaux3, P.ldaux4, P.ldo,    P.ldo2,     P.ldo3,
          P.ldacc, P.out,    P.out2,   P.out3,   P.acc};
}

#define IIC_D16                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define IIC_D16_OUT(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (64 x 32, float32) += A (64 x k) . B (32 x k)^T, both K-major.
template <typename T>
__device__ __forceinline__ void wgmma_64x32(float* d, uint64_t da,
                                            uint64_t db);
template <>
__device__ __forceinline__ void wgmma_64x32<float>(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " IIC_D16
      ", %16, %17, p, 1, 1;\n}\n"
      : IIC_D16_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_64x32<__nv_bfloat16>(float* d,
                                                           uint64_t da,
                                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " IIC_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : IIC_D16_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}

#define IIC_D40                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"
#define IIC_D40_OUT(d)                                                     \
  IIC_D16_OUT(d), IIC_D16_OUT((d + 16)), "+f"(d[32]), "+f"(d[33]),        \
      "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]),     \
      "+f"(d[39])

// d (64 x 80, float32) += A (64 x k) . B (80 x k)^T, both K-major: a
// consumer warpgroup's half of the wide batch tile.
template <typename T>
__device__ __forceinline__ void wgmma_64x80(float* d, uint64_t da,
                                            uint64_t db);
template <>
__device__ __forceinline__ void wgmma_64x80<float>(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 " IIC_D40
      ", %40, %41, p, 1, 1;\n}\n"
      : IIC_D40_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_64x80<__nv_bfloat16>(float* d,
                                                           uint64_t da,
                                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " IIC_D40
      ", %40, %41, p, 1, 1, 0, 0;\n}\n"
      : IIC_D40_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x N) += A . B^T for a warpgroup's n = N.
template <typename T, int N>
__device__ __forceinline__ void wgmma_64xn(float* d, uint64_t da,
                                           uint64_t db) {
  static_assert(N == 32 || N == 80, "the batch widths instantiated");
  if constexpr (N == 32)
    wgmma_64x32<T>(d, da, db);
  else
    wgmma_64x80<T>(d, da, db);
}

template <int N>
__device__ __forceinline__ void wgmma_wait_all_n(float* d) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Waits until at most the latest wgmma group is in flight: d, the sums of
// the group before it, are final.
template <int N>
__device__ __forceinline__ void wgmma_wait_one_n(float* d) {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x with its 13 low mantissa bits cleared: a TF32 value, the hi part of a
// 3xTF32 split whose lo part x - hi is exact in float32 (and 2^-10 of x at
// most, so the tensor cores' TF32 reading of it loses under 2^-20 of x).
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// x rounded to TF32, ties away from zero (cvt.rna.tf32.f32's rounding) in
// two integer operations: the carry of the half unit runs into the kept
// bits, and on into the exponent.  x - tf32_near(x) is exact in float32.
__device__ __forceinline__ float tf32_near(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// One W tile by TMA: box {k0.., row0..} of map into dst (128-byte
// swizzle), under an L2 cache policy; bar receives the bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int k0, int row0, uint64_t* bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_addr(dst)),
      "l"((uint64_t)map), "r"(k0), "r"(row0), "r"(smem_addr(bar)),
      "l"(policy)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cell backward of one (image, unit): the four gate cotangents from the
// float32 pre-activations pre (in gate position order: SCN i, f, o, c, LSTM
// i, f, g, o), c_t, the c before it and dh_t; the dc carry updated.  d
// receives the cotangents in the same order.
__device__ __forceinline__ void cell_bwd(const float* pre, float c_t,
                                         float c_prev, float dh_t, float& dc,
                                         float* d, int lstm) {
  const int go = lstm ? 3 : 2, gg_ = lstm ? 2 : 3;   // o and g positions
  const float ig = sigmoidf_(pre[0]);
  const float fg = sigmoidf_(pre[1]);
  const float og = sigmoidf_(lstm ? pre[3] : pre[2]);
  const float gg = tanhf(lstm ? pre[2] : pre[3]);
  const float tc = tanhf(c_t);
  const float d_o = dh_t * tc * og * (1.0f - og);
  const float dc_t = dc + dh_t * og * (1.0f - tc * tc);
  d[0] = dc_t * gg * ig * (1.0f - ig);
  d[1] = dc_t * c_prev * fg * (1.0f - fg);
  d[go] = d_o;
  d[gg_] = dc_t * ig * (1.0f - gg * gg);
  dc = dc_t * fg;
}

template <typename T>
__device__ __forceinline__ float ld_t(const void* p, long long i) {
  return to_f(((const T*)p)[i]);
}

// Values an epilogue reads per output, loaded for a batch of outputs
// before any is computed: the loads of a batch are in flight together
// (the stores between them could alias, so the compiler would not hoist
// them).  kSmPlain reads nothing.
template <int EPI>
struct EpiIn {
  static constexpr int n = EPI == kSmCell ? 13 : EPI == kSmDh ? 8
                         : EPI == kSmFac ? 3
                         : EPI == kSmStepCell || EPI == kSmScnCell
                                 || EPI == kSmScnCellBf ? 5
                         : EPI == kSmHall || EPI == kSmStepIn
                                 || EPI == kSmStepGather || EPI == kSmLogits
                                 || EPI == kSmF32Mul ? 1 : 2;
  // (kSmPlain reads nothing; one slot keeps the array non-empty)
};

template <typename T, int EPI, typename PP>
__device__ __forceinline__ void epi_load(const PP& P, int z, int r,
                                         int b, float* x) {
  if constexpr (EPI == kSmHall) {
    if (r < P.n1)
      x[0] = ld_t<T>(P.bias1, r);
    else if (r < P.n2)
      x[0] = ld_t<T>(P.bias2, r - P.n1);
    else
      x[0] = P.lstm ? 0.0f : ld_t<T>(P.aux, b * P.ldaux + r - P.n2);
  } else if constexpr (EPI == kSmXfac) {
    x[0] = ld_t<T>(P.aux, b * P.ldaux + r);
    x[1] = ld_t<T>(P.aux2, b * P.ldaux2 + r);
  } else if constexpr (EPI == kSmCell) {
    const int H = P.rows;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      x[g] = ((const float*)P.bias1)[g * H + r];
      if (P.lstm) {
        x[4 + g] = ld_t<T>(P.aux, b * P.ldaux + g * H + r);
        x[8 + g] = ((const float*)P.aux2)[b * P.ldaux2 + g * H + r];
      }
    }
    x[12] = ld_t<T>(P.aux3, b * P.ldaux3 + r);
  } else if constexpr (EPI == kSmFac) {
    const int col = z * P.rows + r;
    x[0] = P.aux2_f32 ? ((const float*)P.aux2)[b * P.ldaux2 + col]
                      : ld_t<T>(P.aux2, b * P.ldaux2 + col);
    x[1] = ld_t<T>(P.aux, b * P.ldaux + col);
    x[2] = P.acc[b * P.ldacc + col];
  } else if constexpr (EPI == kSmGateBwd) {
    x[0] = ((const float*)P.aux2)[b * P.ldaux2 + r];
    x[1] = ld_t<T>(P.aux, b * P.ldaux + r);
  } else if constexpr (EPI == kSmDh) {
    if (P.n1 == 0) return;
    // the step before: aux2 its pre-activations (float32), aux its c, aux3
    // the c before it, aux4 its d_hall; acc the dc carry
    const int H = P.rows;
    const float* pre = (const float*)P.aux2 + b * P.ldaux2 + r;
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = pre[g * H];
    x[4] = ld_t<T>(P.aux, b * P.ldaux + r);
    x[5] = ld_t<T>(P.aux3, b * P.ldaux3 + r);
    x[6] = ld_t<T>(P.aux4, b * P.ldaux4 + r);
    x[7] = P.acc[b * P.ldacc + r];
  } else if constexpr (EPI == kSmStepIn || EPI == kSmStepGather) {
    if (r < P.n1)
      x[0] = ld_t<T>(P.bias1, r);
    else if (r < P.n2)
      x[0] = ld_t<T>(P.bias2, r - P.n1);
    else
      x[0] = P.aux ? ld_t<T>(P.aux, b * P.ldaux + r - P.n2) : 1.0f;
  } else if constexpr (EPI == kSmStepCell) {
    const int H = P.rows;
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = ((const float*)P.bias1)[g * H + r];
    x[4] = ld_t<T>(P.aux3, b * P.ldaux3 + r);
  } else if constexpr (EPI == kSmLogits) {
    x[0] = ld_t<T>(P.bias1, r);
  } else if constexpr (EPI == kSmF32Mul) {
    x[0] = ld_t<T>(P.aux, b * P.ldaux + r);
  } else if constexpr (EPI == kSmScnCell || EPI == kSmScnCellBf) {
    const int H = P.rows;
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = ((const float*)P.bias1)[g * H + r];
    x[4] = EPI == kSmScnCellBf ? ld_t<__nv_bfloat16>(P.aux3, b * P.ldaux3 + r)
                               : ld_t<T>(P.aux3, b * P.ldaux3 + r);
  }
}

template <typename T, int EPI, typename PP>
__device__ __forceinline__ void epi_store(const PP& P, int z, int r,
                                          int b, const float* v,
                                          const float* x) {
  if constexpr (EPI == kSmHall) {
    if (r < P.n2)
      ((float*)P.out)[b * P.ldo + r] = v[0] + x[0];
    else if (P.lstm)
      ((float*)P.out2)[b * P.ldo2 + r - P.n2] = v[0];
    else
      ((T*)P.out2)[b * P.ldo2 + r - P.n2] = from_f<T>(rt<T>(v[0]) * x[0]);
  } else if constexpr (EPI == kSmXfac) {
    const float xin = rt<T>(rt<T>(v[0]) + x[0]);
    ((T*)P.out)[b * P.ldo + r] = from_f<T>(xin * x[1]);
  } else if constexpr (EPI == kSmCell) {
    float pre[4];   // as the plain version: (xin + h @ wh) + (bx + bh)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      pre[g] = (P.lstm ? rt<T>(rt<T>(v[g]) + x[4 + g]) + x[8 + g] : v[g]) +
               x[g];
    const float ig = rt<T>(sigmoidf_(pre[0]));
    const float fg = rt<T>(sigmoidf_(pre[1]));
    const float og = rt<T>(sigmoidf_(P.lstm ? pre[3] : pre[2]));
    const float gg = rt<T>(tanhf(P.lstm ? pre[2] : pre[3]));
    const float cn = rt<T>(rt<T>(fg * x[12]) + rt<T>(ig * gg));
    const float hn = rt<T>(og * rt<T>(tanhf(cn)));
    ((T*)P.out)[b * P.ldo + r] = from_f<T>(hn);
    ((T*)P.out2)[b * P.ldo2 + r] = from_f<T>(cn);
  } else if constexpr (EPI == kSmFac) {
    const int col = z * P.rows + r;
    P.acc[b * P.ldacc + col] = x[2] + v[0] * x[0];
    ((T*)P.out)[b * P.ldo + col] = from_f<T>(v[0] * x[1]);
  } else if constexpr (EPI == kSmGateBwd) {
    const float g = x[0];
    ((T*)P.out2)[b * P.ldo2 + r] = from_f<T>(v[0] * g);
    ((T*)P.out)[b * P.ldo + r] = from_f<T>(v[0] * x[1] * g * (1.0f - g));
  } else if constexpr (EPI == kSmPlain) {
    ((float*)P.out)[b * P.ldo + r] = v[0];
  } else if constexpr (EPI == kSmStepIn || EPI == kSmStepGather) {
    const float x0 = rt<T>(v[0]);
    if (r < P.n1)
      ((T*)P.out)[b * P.ldo + r] = from_f<T>(x0 + x[0]);
    else if (r < P.n2)
      ((T*)P.out2)[b * P.ldo2 + r - P.n1] =
          from_f<T>(sigmoidf_(rt<T>(x0 + x[0])));
    else
      ((T*)P.out3)[b * P.ldo3 + r - P.n2] = from_f<T>(x0 * x[0]);
  } else if constexpr (EPI == kSmStepCell) {
    float pre[4];   // as the body: the gates' float32 sums cast to T
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[g] = rt<T>(v[g] + x[g]);
    const float ig = rt<T>(sigmoidf_(pre[0]));
    const float fg = rt<T>(sigmoidf_(pre[1]));
    const float og = rt<T>(sigmoidf_(P.lstm ? pre[3] : pre[2]));
    const float gg = rt<T>(tanhf(P.lstm ? pre[2] : pre[3]));
    const float cn = rt<T>(rt<T>(fg * x[4]) + rt<T>(ig * gg));
    const float hn = rt<T>(og * rt<T>(tanhf(cn)));
    ((T*)P.out)[b * P.ldo + r] = from_f<T>(hn);
    ((T*)P.out2)[b * P.ldo2 + r] = from_f<T>(cn);
  } else if constexpr (EPI == kSmLogits) {
    ((float*)P.out)[b * P.ldo + r] = rt<T>(rt<T>(v[0]) + x[0]);
  } else if constexpr (EPI == kSmF32Mul) {
    ((float*)P.out)[b * P.ldo + r] = v[0] * x[0];
  } else if constexpr (EPI == kSmScnCell || EPI == kSmScnCellBf) {
    // as scn_pallas.py: the gates' float32 sums plus b, the sigmoid, tanh
    // and cell in float32, one cast of h' and c' (SCN gates i, f, o, c)
    const float ig = sigmoidf_(v[0] + x[0]);
    const float fg = sigmoidf_(v[1] + x[1]);
    const float og = sigmoidf_(v[2] + x[2]);
    const float gg = tanhf(v[3] + x[3]);
    const float cn = fg * x[4] + ig * gg;
    const float hn = og * tanhf(cn);
    using O = std::conditional_t<EPI == kSmScnCellBf, __nv_bfloat16, T>;
    ((O*)P.out)[b * P.ldo + r] = from_f<O>(hn);
    ((O*)P.out2)[b * P.ldo2 + r] = from_f<O>(cn);
  } else if constexpr (EPI == kSmDh) {
    if (P.n1 == 0) {
      ((float*)P.out)[b * P.ldo + r] = v[0];
      return;
    }
    const int H = P.rows;
    float dc = x[7], d[4];
    cell_bwd(x, x[4], x[5], v[0] + x[6], dc, d, P.lstm);
    P.acc[b * P.ldacc + r] = dc;
    T* dp = (T*)P.out2 + b * P.ldo2 + r;
#pragma unroll
    for (int g = 0; g < 4; ++g) dp[g * H] = from_f<T>(d[g]);
  }
}


// The product's fields where the block reads them: the parameter itself (n
// = 32), or a copy in shared memory (the wide tile).
template <int NB>
__device__ __forceinline__ const SmallProb& param_copy(const SmallProb& g) {
  if constexpr (NB > kSmN) {
    __shared__ __align__(64) SmallProb s;
    static_assert(sizeof(SmallProb) % 4 == 0, "copied in words");
    for (int i = threadIdx.x; i < (int)(sizeof(SmallProb) / 4);
         i += blockDim.x)
      ((int*)&s)[i] = ((const int*)&g)[i];
    __syncthreads();
    return s;
  } else {
    return g;
  }
}

template <typename T, int EPI, int NB>
__global__ void __launch_bounds__(Sm<T, NB>::kThreads)
    small_gemm_kernel(const __grid_constant__ SmallLaunch L) {
  using C = Sm<T, NB>;
  constexpr int BK = C::kBK, EPC = C::kEpc, S = C::kStages, D = C::kAhead;
  constexpr int NT = C::kThreads, NW = C::kNW;
  constexpr bool kWLo = C::kF32 && kSmWLo<EPI>;
  constexpr bool kRound = NB > kSmN && EPI == kSmLogits;   // see the top
  constexpr bool kGather = NB > kSmN && EPI == kSmStepGather;
  namespace cg = cooperative_groups;
  if (skip(L.live)) return;   // every block of the launch reads the same word
  extern __shared__ __align__(1024) unsigned char sm_raw[];
  __shared__ __align__(8) uint64_t full[S];   // W tile t landed (TMA)
  T* ring = (T*)(((uintptr_t)sm_raw + 1023) & ~(uintptr_t)1023);
  T* lo_buf = ring + S * C::kStage;    // kLo x (W lo, X lo), float32 only

  int blk = blockIdx.x, pi = 0;
  while (pi + 1 < L.nprob && blk >= L.p[pi].blocks) blk -= L.p[pi++].blocks;
  // the wide tile reads its product's fields from a copy in shared memory:
  // the parameter, indexed by a block-dependent pi, is read through its
  // generic address, slowly, and again after every store; only the TMA
  // descriptors must stay in parameter space
  const SmallProb& Pg = L.p[pi];
  const SmallProb& P = param_copy<NB>(Pg);
  const int tid = threadIdx.x;
  const int ks = blk % P.ksplit, rt = blk / P.ksplit;
  const int z = rt % P.nz, lt = rt / P.nz;
  const int r0 = lt * kSmM, b0 = blockIdx.y * NB;
  const long long wrow0 = z * P.z_rows + lt * P.lt_rows;

  // this block's K tiles [t_lo, t_lo + nt) of the sources' tiles in order;
  // source(u) turns tile u into (source, its tile)
  const int nt0 = (P.k[0] + BK - 1) / BK;
  const int nt1 = P.nsrc > 1 ? (P.k[1] + BK - 1) / BK : 0;
  auto source = [&](int& u) {
    if (u < nt0) return 0;
    u -= nt0;
    if (u < nt1) return 1;
    u -= nt1;
    return 2;
  };
  const int t_lo = ks * P.tchunk;
  const int nt = max(min(P.ktiles, t_lo + P.tchunk) - t_lo, 0);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // W: one TMA copy a tile (thread 0), or, for a row stride TMA does not
  // take, element loads by every thread into this thread's chunks: chunk
  // wc of rows wr + (NT / 8) j (j < kWJ); X: this thread's chunks q (h <
  // kXC), chunk q % 8 of row q / 8, q = tid kXC + h, or, in the wide tile,
  // tid + h NT: a warp's copy is then four whole 128-byte rows
  const uint64_t pol = l2_evict_last();
  const int wc = tid & 7, wr = tid >> 3;
  auto w_at = [&](int j) {
    const int r = wr + (NT / 8) * j;
    return r * BK + ((wc ^ (r & 7)) * EPC);
  };
  auto xq = [&](int h) {
    return NB > kSmN ? tid + h * NT : tid * C::kXC + h;
  };
  auto x_at = [&](int h) {
    const int q = xq(h), xr = q >> 3;
    return C::kW + xr * BK + (((q & 7) ^ (xr & 7)) * EPC);
  };
  // kGather: the row of source 0 that each of this thread's X chunks
  // reads, its batch row or the id of a gather, read once
  int xrow[C::kXC];
  if constexpr (kGather) {
#pragma unroll
    for (int h = 0; h < C::kXC; ++h) {
      const int b = b0 + (xq(h) >> 3);
      xrow[h] = b;
      if (P.xid != nullptr && b < L.B) {
        const int id = P.xid[b];
        if ((unsigned)id >= (unsigned)P.xid_rows) __trap();
        xrow[h] = id;
      }
    }
  }
  auto load_w = [&](int u, int st) {
    const int s = source(u);
    T* dst = ring + st * C::kStage;
    const T* W = (const T*)P.w[s];
    const long long ldw = P.ldw[s];
    if (P.w_al[s]) {
      if (tid == 0) {
        mbar_expect_tx(&full[st], C::kW * (int)sizeof(T));
        tma_load_2d(dst, &Pg.map[s], u * BK, (int)wrow0, &full[st], pol);
      }
    } else {
      const int gw = u * BK + wc * EPC;
      const int kw = min(max(P.k[s] - gw, 0), EPC);
#pragma unroll
      for (int j = 0; j < C::kWJ; ++j) {
        const int r = wr + (NT / 8) * j;
        const bool ok = r0 + r < P.rows && kw > 0;
        const T* src = W + (wrow0 + r) * ldw + gw;
        T* d = dst + w_at(j);
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          d[e] = (ok && e < kw) ? src[e] : from_f<T>(0.0f);
      }
      if (tid == 0) mbar_arrive(&full[st]);
    }
  };
  auto load_x = [&](int u, int st) {
    const int s = source(u);
    T* dst = ring + st * C::kStage;
    const T* X = (const T*)P.x[s] + z * P.zx;
#pragma unroll
    for (int h = 0; h < C::kXC; ++h) {
      const int q = xq(h);
      const int b = b0 + (q >> 3);
      const int gx = u * BK + (q & 7) * EPC;
      const int kx = b < L.B ? min(max(P.k[s] - gx, 0), EPC) : 0;
      const int row = kGather && s == 0 ? xrow[h] : b;
      const T* src = X + (long long)row * P.ldx[s] + gx;
      T* d = dst + x_at(h);
      if (P.x_al[s]) {
        cp_async16(d, kx > 0 ? src : X, kx * (int)sizeof(T));
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          d[e] = e < kx ? src[e] : from_f<T>(0.0f);
      }
    }
  };
  // float32: this thread's own chunks of a stage (its copies, or the W
  // tile after the mbarrier, are visible to it), lo = x - tf32_trunc(x)
  // (exact) at the same offsets of lo; x itself stays as the hi operand,
  // since the tensor cores read a TF32 operand by dropping the 13 low
  // mantissa bits, which is tf32_trunc
  auto split = [&](T* sw, T* lo) {
    auto one = [&](int at) {
      const float4 x = *(const float4*)(sw + at);
      if constexpr (kRound) {           // rounded: hi over x, lo beside
        const float4 h = make_float4(tf32_near(x.x), tf32_near(x.y),
                                     tf32_near(x.z), tf32_near(x.w));
        *(float4*)(sw + at) = h;
        *(float4*)(lo + at) =
            make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
      } else {
        *(float4*)(lo + at) =
            make_float4(x.x - tf32_trunc(x.x), x.y - tf32_trunc(x.y),
                        x.z - tf32_trunc(x.z), x.w - tf32_trunc(x.w));
      }
    };
    if constexpr (kWLo) {
#pragma unroll
      for (int j = 0; j < C::kWJ; ++j) one(w_at(j));
    }
#pragma unroll
    for (int h = 0; h < C::kXC; ++h) one(x_at(h));
  };

  // consumer warpgroup wg multiplies the W tile by batch rows [wg NW, (wg
  // + 1) NW) of the X tile: NW rows of 128 bytes, whole swizzle atoms
  const int wg = tid / kSmThreads;
  const int xoff = C::kW + wg * NW * BK;
  float d[NW / 2], da[NW / 2], db[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) d[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < nt) {
      load_w(t_lo + i, i);
      load_x(t_lo + i, i);
    }
    cp_async_commit();
  }
  auto step = [&](float (&cur)[NW / 2], float (&prev)[NW / 2], int t) {
    cp_async_wait<D - 1>();            // this thread's copies of tile t
    mbar_wait(&full[t % S], (t / S) & 1);   // and its W tile
    T* sw = ring + (t % S) * C::kStage;
    // tile t's lo parts: written before this tile's barrier, while a warp
    // may still wait on tile t - 2's products (a warp's wgmma.wait_group
    // covers its own part; with kWait, on tile t - 1's), so three buffers
    // (two)
    T* lo = lo_buf + (t % (C::kLo > 0 ? C::kLo : 1)) * C::kStage;
    if constexpr (C::kF32) split(sw, lo);
    fence_proxy_async();
    __syncthreads();   // tile t is in; tile t + D - S's products are done
    if (t + D < nt) {
      load_w(t_lo + t + D, (t + D) % S);
      load_x(t_lo + t + D, (t + D) % S);
    }
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) cur[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = k * 32 / (int)sizeof(T);   // 32 bytes of K a step
      const uint64_t wh = wgmma_desc(sw + o);
      const uint64_t xh = wgmma_desc(sw + xoff + o);
      if constexpr (C::kF32) {
        if constexpr (kWLo) wgmma_64xn<T, NW>(cur, wgmma_desc(lo + o), xh);
        wgmma_64xn<T, NW>(cur, wh, wgmma_desc(lo + xoff + o));
      }
      wgmma_64xn<T, NW>(cur, wh, xh);
    }
    wgmma_commit();
    if constexpr (C::kWait) {
      // the sums of tile t, at once: reading the accumulators of a group
      // in flight (below) makes the compiler wait after every wgmma, so a
      // tile's 12 float32 products would run one at a time
      wgmma_wait_all_n<NW>(cur);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) d[i] += cur[i];
    } else if (t > 0) {                // tile t - 1's sums are final
      wgmma_wait_one_n<NW>(prev);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) d[i] += prev[i];
    }
  };
  int t = 0;
  if constexpr (C::kWait) {
    for (; t < nt; ++t) step(da, da, t);
  } else {
    for (; t + 1 < nt; t += 2) {
      step(da, db, t);
      step(db, da, t + 1);
    }
    if (t < nt) step(da, db, t);
  }
  if (!C::kWait && nt > 0) {
    if ((nt - 1) & 1) {
      wgmma_wait_all_n<NW>(db);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) d[i] += db[i];
    } else {
      wgmma_wait_all_n<NW>(da);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) d[i] += da[i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free

  // this block's sums, 64 rows x NB batch columns, row-major: accumulator
  // j*4 + i of thread (warp w of warpgroup wg, lane l) is row 16 w + l / 4
  // (+8 for i >= 2), column wg NW + 8 j + 2 (l % 4) + i % 2
  float* red = (float*)ring;
  constexpr int LDR = C::kLdr;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(16 * warp + lane / 4 + (i >= 2 ? 8 : 0)) * LDR + wg * NW + 8 * j +
          2 * (lane % 4) + (i & 1)] = d[j * 4 + i];
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();

  // the cluster's blocks: (group slice g, K slice sl) at rank g ksplit +
  // sl; rank c finishes rows [c nr, (c + 1) nr) of the group's outputs
  const int G = P.group, CS = G * P.ksplit;
  const int rank = (int)cl.block_rank();
  // block rk's sums; the wide tile reads its own without the cluster's
  // address window
  auto sums = [&](int rk) -> const float* {
    if constexpr (NB > kSmN)
      if (rk == rank) return red;
    return cl.map_shared_rank(red, rk);
  };
  const int nr = (kSmM + CS - 1) / CS;
  const int zg = G == 1 ? z : 0;
  // each output's (row of the tile, batch column): the n = 32 tile walks
  // positions pos = p NT + tid; the wide one gives each thread one row and
  // walks columns, with no division in the loop (its 8 warps a block leave
  // little to hide an instruction's latency behind)
  const int npos = nr * NB, cpt = NT / nr;   // wide: columns a pass
  const int my_r = tid % nr, my_c = tid / nr;
  const int passes = NB > kSmN ? (NB + cpt - 1) / cpt : (npos + NT - 1) / NT;
  constexpr int U = NB > kSmN ? 8 : 4;   // outputs whose loads fly together
  const int ksl = P.ksplit, nb = L.B;
  auto finish = [&](const auto& E) {
    for (int p = 0; p < passes; p += U) {
      float x[U][EpiIn<EPI>::n], v[U][4];
      int rr[U], bb[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int rl, col;                     // row of the tile, batch column
        bool in;
        if constexpr (NB > kSmN) {
          rl = rank * nr + my_r;
          col = my_c + (p + u) * cpt;
          in = my_c < cpt && col < NB;
        } else {
          const int pos = (p + u) * NT + tid;
          rl = rank * nr + pos % nr;
          col = pos / nr;
          in = pos < npos;
        }
        rr[u] = r0 + rl;
        bb[u] = b0 + col;
        ok[u] = in && rl < kSmM && rr[u] < E.rows && bb[u] < nb;
        if (!ok[u]) continue;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          v[u][g] = 0.0f;
          if (g >= G) continue;
          if (NB > kSmN && CS == 1)      // the block's own sums, no window
            v[u][g] = red[rl * LDR + col];
          else
            for (int sl = 0; sl < ksl; ++sl)
              v[u][g] += sums(g * ksl + sl)[rl * LDR + col];
        }
        if constexpr (EPI != kSmPlain)
          epi_load<T, EPI>(E, zg, rr[u], bb[u], x[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) epi_store<T, EPI>(E, zg, rr[u], bb[u], v[u], x[u]);
    }
  };
  if constexpr (NB > kSmN)
    finish(epi_params(P));
  else
    finish(P);
  cl.sync();   // no block leaves while another reads its shared memory
}

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

// W source s of p as a TMA descriptor: (wrows, k) values, row stride ldw,
// boxes of 64 rows x 128 bytes in the 128-byte swizzle, zeros past the
// edges.  The last Sm::kMaps descriptors are kept: a scan's weights, and
// a served tree's packs, are the same tensors at every step.
template <typename T, int NB>
static int w_tensor_map(SmallProb& p, int s) {
  struct Entry {
    const void* w;
    long long ldw, rows;
    int k;
    CUtensorMap map;
  };
  constexpr int kN = Sm<T, NB>::kMaps;
  static Entry cache[kN];
  static int next = 0;
  for (const Entry& e : cache)
    if (e.w == p.w[s] && e.ldw == p.ldw[s] && e.rows == p.wrows[s] &&
        e.k == p.k[s]) {
      p.map[s] = e.map;
      return 0;
    }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)p.k[s], (cuuint64_t)p.wrows[s]};
  const cuuint64_t strides[1] = {(cuuint64_t)p.ldw[s] * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Sm<T>::kBK, (cuuint32_t)kSmM};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      &p.map[s],
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, (void*)p.w[s], dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  cache[next] = {p.w[s], p.ldw[s], p.wrows[s], p.k[s], p.map[s]};
  next = (next + 1) % kN;
  return 0;
}

// Plans each product's blocks (split-K for about Sm::kTarget blocks in
// all, at least two K tiles a slice, a cluster of group x ksplit blocks
// within Sm::kMaxCluster, the same for both products of a launch) and
// launches batch tiles of NB rows.
template <typename T, int EPI, int NB = kSmN>
static int launch_small(SmallLaunch L, cudaStream_t stream) {
  using C = Sm<T, NB>;
  constexpr int BK = C::kBK, EPC = C::kEpc;
  if (L.B < 1 || L.nprob < 1 || L.nprob > kSmProbs)
    return (int)cudaErrorInvalidValue;
  const int nbt = (L.B + NB - 1) / NB;
  const int G = L.p[0].group;
  int tiles_all = 0, ks = C::kMaxCluster / G;
  for (int pi = 0; pi < L.nprob; ++pi) {
    SmallProb& p = L.p[pi];
    if (p.epi != EPI || p.group != G || p.nsrc < 1 || p.nsrc > 3 ||
        p.rows < 1 || p.nz < 1 || (G != 1 && G != p.nz) || G > 4)
      return (int)cudaErrorInvalidValue;
    p.ktiles = 0;
    for (int s = 0; s < p.nsrc; ++s) {
      if (p.k[s] < 1 || p.wrows[s] < 1) return (int)cudaErrorInvalidValue;
      p.ktiles += (p.k[s] + BK - 1) / BK;
      p.w_al[s] = (uintptr_t)p.w[s] % 16 == 0 && p.ldw[s] % EPC == 0;
      if (p.w_al[s]) {
        const int err = w_tensor_map<T, NB>(p, s);
        if (err != 0) return err;
      }
      p.x_al[s] = (uintptr_t)p.x[s] % 16 == 0 && p.ldx[s] % EPC == 0 &&
                  p.zx % EPC == 0;
    }
    tiles_all += ((p.rows + kSmM - 1) / kSmM) * p.nz;
    ks = std::min(ks, std::max(1, p.ktiles / 2));
  }
  ks = std::max(1, std::min(ks, C::kTarget / (tiles_all * nbt)));
  const auto kernel = small_gemm_kernel<T, EPI, NB>;
  constexpr size_t smem = C::kSmem;
  static bool ready = false;      // the attributes, once per instance
  if (!ready) {
    int err = allow_smem(kernel, smem);
    if (err == 0)
      err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != 0) return err;
    ready = true;
  }
  if constexpr (NB > kSmN) {
    // a wide block fills its SM, and a cluster's blocks share a GPC: take
    // the largest split whose clusters are all resident at once, so no
    // cluster waits for a second wave
    static int fit[5][C::kMaxCluster + 1] = {};   // 1 + clusters resident
    const int want = tiles_all * nbt / G;          // clusters
    while (ks > 1) {
      int& f = fit[G][G * ks];
      if (f == 0) {
        cudaLaunchConfig_t q = {};
        q.gridDim = dim3(G * ks);
        q.blockDim = dim3(C::kThreads);
        q.dynamicSmemBytes = smem;
        cudaLaunchAttribute a[1];
        a[0].id = cudaLaunchAttributeClusterDimension;
        a[0].val.clusterDim.x = G * ks;
        a[0].val.clusterDim.y = a[0].val.clusterDim.z = 1;
        q.attrs = a;
        q.numAttrs = 1;
        int n = 0;
        if (cudaOccupancyMaxActiveClusters(&n, kernel, &q) != cudaSuccess) {
          cudaGetLastError();
          n = 0;
        }
        f = 1 + n;
      }
      if (f - 1 >= want) break;
      --ks;
    }
  }
  for (int pi = 0; pi < L.nprob; ++pi) {
    SmallProb& p = L.p[pi];
    p.tchunk = (p.ktiles + ks - 1) / ks;
    p.ksplit = ks;   // a slice past the last tile computes zeros
    p.blocks = ((p.rows + kSmM - 1) / kSmM) * p.nz * ks;
  }
  L.cluster = G * ks;
  int blocks = 0;
  for (int pi = 0; pi < L.nprob; ++pi) blocks += L.p[pi].blocks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, nbt);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel, L);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// One product of `rows` output rows with epilogue epi, no sources yet.
static inline SmallProb small_prob(int rows, int epi) {
  SmallProb p = {};
  p.rows = rows;
  p.nz = 1;
  p.group = 1;
  p.lt_rows = kSmM;
  p.epi = epi;
  return p;
}

// Source s of a small product: x (batch rows, ldx) times W (wrows rows,
// ldw), K = k.
static inline void small_src(SmallProb& p, const void* x, long long ldx,
                             const void* w, long long ldw, long long wrows,
                             int k) {
  const int s = p.nsrc++;
  p.x[s] = x;
  p.ldx[s] = ldx;
  p.w[s] = w;
  p.ldw[s] = ldw;
  p.wrows[s] = wrows;
  p.k[s] = k;
}

// The gate-interleaved packs: z-slice g of 64-row tile u at rows (4 u + g)
// 64 (ops/train_cuda.py pack_gates).
static inline void gates_interleaved(SmallProb& p) {
  p.nz = 4;
  p.group = 4;
  p.z_rows = kSmM;
  p.lt_rows = 4 * kSmM;
}

// launch_small for the epilogue of the launch's products (L.p[0].epi).
template <typename T>
static int launch_small_epi(const SmallLaunch& L, cudaStream_t stream) {
  switch (L.p[0].epi) {
#define IIC_SMALL_CASE(e) \
  case e:                 \
    return launch_small<T, e>(L, stream);
    IIC_SMALL_CASE(kSmHall)
    IIC_SMALL_CASE(kSmXfac)
    IIC_SMALL_CASE(kSmCell)
    IIC_SMALL_CASE(kSmFac)
    IIC_SMALL_CASE(kSmGateBwd)
    IIC_SMALL_CASE(kSmDh)
    IIC_SMALL_CASE(kSmPlain)
#undef IIC_SMALL_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace iic
