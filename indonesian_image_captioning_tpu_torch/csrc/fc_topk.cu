// Kernel 11: the vocab projection with its per-row log-sum and top-k.
//
// Replaces indonesian_image_captioning_tpu/ops/fc_topk_pallas.py fc_topk
// (body _make_kernel): for h (R, D), w (D, V) and b (V,), all float32,
//
//   logits = h @ w + b
//   topv, topi (R, k): the k largest raw logits of each row, ties to the
//                      lowest vocab id (lax.top_k's order)
//   lse (R,)         = log sum_v exp(logits - max) + max
//
// so topv - lse are the log-probabilities of the k best words.  The Pallas
// kernel pads the vocab to its 512-column tile with logit NEG and never
// writes the logits: it folds each vocab tile into an online max-and-sum
// and a sorted top-k.  So does this kernel, in two launches:
//
//   fc_tile_kernel   a CTA owns 64 vocab rows of w^T (the K-major pack of
//                    w, ops/fc_topk.py fc_pack) against NB = 80 rows of h
//                    (grid: vocab tiles x batch tiles).  The product runs on
//                    the tensor cores, swap-AB as the decode chain's head
//                    (mma_small.cuh): the vocab rows are wgmma's M, the
//                    batch rows its N (m64n80k8), so each W tile is read
//                    once per 80 rows.  3xTF32 with a rounded hi part, as
//                    mma_small.cuh's kSmLogits: hi = tf32_near(x) written
//                    back over x, lo = x - hi (exact), C = lo.hi + hi.lo +
//                    hi.hi, whose error does not lean one way; each K
//                    tile's sums go into fresh registers and are added to
//                    the float32 accumulator after the tile.  W tiles come
//                    by TMA (128-byte swizzle, an mbarrier a stage), h's by
//                    16-byte cp.async, in a ring of kFcStages stages.  The
//                    epilogue adds the bias and folds each batch row's 64
//                    logits, one thread a row, into a partial: the max, the
//                    sum of exp(x - max), and the kt = min(k, 64) best (value
//                    desc, id asc) in a sorted list in registers.
//   fc_merge_kernel  a warp a row merges the row's ceil(V / 64) partials:
//                    lse = log sum_t s_t exp(m_t - m) + m, and k rounds of
//                    the maximum over the tiles' sorted lists' heads.
//
// The logits never reach device memory (at COCO's V = 38,732 they would
// be 24.8 MB); the partials are R ceil(V / 64) (2 + 2 kt) words.  Every
// sum has one owner and one order, so a call is deterministic.
//
// What bounds it: at R = 160 rows (B = 32, K = 5), D = 512, V = 6,763 the
// product is 2 R D V = 1.11 GFLOP, three times over at 3xTF32: 0.0067 ms
// at 495 / 3 TFLOP/s, against 13.9 MB of weights (0.0041 ms at 3.35 TB/s)
// -- the tensor cores' operations.  The first design (gemm.cuh's FFMA
// GEMM writing the logits, then step.cuh's head reading them back) was
// bound at 0.0165 ms by the FFMA peak it ran on.  What the design does
// about it: the products on the tensor cores; 212 CTAs of 109 KB at the
// flagship shape (two an SM) so every SM multiplies; the head folded
// into the product's epilogue, so nothing but the partials is written.
// What holds it back now: the per-tile code more than the products --
// every CTA splits its h tile again (the 106 vocab tiles re-read and
// re-split the same 160 x 512 rows of h), the epilogue's fold is one
// thread a batch row over 64 words, each K tile passes a barrier, and the
// merge is a second launch.
#include <climits>

#include "mma_small.cuh"

namespace iic {

constexpr int kFcM = 64;                 // vocab rows of a CTA
constexpr int kFcNB = 80;                // batch rows of a CTA: wgmma's n
constexpr int kFcBK = 32;                // K of a tile: 128 bytes
constexpr int kFcThreads = 128;          // one warpgroup
constexpr int kFcStages = 4, kFcAhead = kFcStages - 1, kFcLo = 2;
constexpr int kFcW = kFcM * kFcBK;       // floats of a W tile
constexpr int kFcX = kFcNB * kFcBK;      // of an h tile
constexpr int kFcStage = kFcW + kFcX;
constexpr int kFcMaxKt = 64;             // a tile's list: min(k, 64)
constexpr int kFcLdr = kFcNB + 1;        // the epilogue's row stride
constexpr size_t kFcSmem =
    sizeof(float) * (size_t)(kFcStages + kFcLo) * kFcStage + 1024;
constexpr int kFcMergeWarps = 4;
static_assert(kFcSmem <= 232448 / 2 - 1024, "two CTAs an SM");
static_assert(kFcM * kFcLdr <= kFcStages * kFcStage, "the epilogue's sums");

// ops/fc_topk.py FcPlan, field for field.
struct FcPlan {
  long long nt, bt, nb, kt, smem, stage, merge_smem;
};

struct FcArgs {
  CUtensorMap map;     // w^T (V rows, D values, ldw apart) by TMA
  const float* h;      // (R, ldh)
  const float* b;      // (V,)
  float* pm;           // partials (R, nt): max,
  float* ps;           //   sum of exp(x - max),
  float* pv;           //   (R, nt, kt) values and
  int* pi;             //   their ids
  long long ldh;
  int R, D, V, nt, kt, h_al;
};

// KT >= kt: the slots of a fold's sorted list (8, 16, 32 or 64).
template <int KT>
__global__ void __launch_bounds__(kFcThreads)
    fc_tile_kernel(const __grid_constant__ FcArgs a) {
  constexpr int BK = kFcBK, S = kFcStages, D_ = kFcAhead, NW = kFcNB;
  extern __shared__ __align__(1024) unsigned char fc_raw[];
  __shared__ __align__(8) uint64_t full[S];   // W tile landed (TMA)
  __shared__ float bias_s[kFcM];              // the tile's bias
  float* ring = (float*)(((uintptr_t)fc_raw + 1023) & ~(uintptr_t)1023);
  float* lo_buf = ring + S * kFcStage;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vt = blockIdx.x, v0 = vt * kFcM, b0 = blockIdx.y * kFcNB;
  const int nt = (a.D + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kFcM) bias_s[tid] = v0 + tid < a.V ? a.b[v0 + tid] : 0.0f;
  __syncthreads();

  // W: one TMA copy a tile (thread 0); this thread splits chunk wc of rows
  // wr + 16 j (j < 4).  h: this thread's chunks q = tid + 128 j (j < 5),
  // chunk q % 8 of row q / 8 (a warp's copy is four whole 128-byte rows).
  const uint64_t pol = l2_evict_last();
  const int wc = tid & 7, wr = tid >> 3;
  constexpr int kWJ = kFcM * 8 / kFcThreads, kXC = kFcNB * 8 / kFcThreads;
  auto w_at = [&](int j) {
    const int r = wr + 16 * j;
    return r * BK + ((wc ^ (r & 7)) * 4);
  };
  auto x_at = [&](int j) {
    const int q = tid + j * kFcThreads, xr = q >> 3;
    return kFcW + xr * BK + (((q & 7) ^ (xr & 7)) * 4);
  };
  auto load = [&](int u, int st) {
    float* dst = ring + st * kFcStage;
    if (tid == 0) {
      mbar_expect_tx(&full[st], kFcW * (int)sizeof(float));
      tma_load_2d(dst, &a.map, u * BK, v0, &full[st], pol);
    }
#pragma unroll
    for (int j = 0; j < kXC; ++j) {
      const int q = tid + j * kFcThreads;
      const int b = b0 + (q >> 3);
      const int gx = u * BK + (q & 7) * 4;
      const int kx = b < a.R ? min(max(a.D - gx, 0), 4) : 0;
      const float* src = a.h + (long long)b * a.ldh + gx;
      float* d = dst + x_at(j);
      if (a.h_al) {
        cp_async16(d, kx > 0 ? src : a.h, kx * (int)sizeof(float));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = e < kx ? src[e] : 0.0f;
      }
    }
  };
  // hi = tf32_near(x) over x, lo = x - hi beside it, on this thread's own
  // chunks (its copies, or the W tile after the mbarrier)
  auto split = [&](float* sw, float* lo) {
    auto one = [&](int at) {
      const float4 x = *(const float4*)(sw + at);
      const float4 h = make_float4(tf32_near(x.x), tf32_near(x.y),
                                   tf32_near(x.z), tf32_near(x.w));
      *(float4*)(sw + at) = h;
      *(float4*)(lo + at) =
          make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
    };
#pragma unroll
    for (int j = 0; j < kWJ; ++j) one(w_at(j));
#pragma unroll
    for (int j = 0; j < kXC; ++j) one(x_at(j));
  };

  float d[NW / 2], cur[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) d[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < D_; ++i) {
    if (i < nt) load(i, i);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<D_ - 1>();               // this thread's copies of tile t
    mbar_wait(&full[t % S], (t / S) & 1);   // and its W tile
    float* sw = ring + (t % S) * kFcStage;
    // tile t's lo parts: a warp may still run tile t - 1's products (its
    // wgmma.wait_group covers its own part), so two buffers
    float* lo = lo_buf + (t % kFcLo) * kFcStage;
    split(sw, lo);
    fence_proxy_async();
    __syncthreads();   // tile t is in; tile t - 1's products are done
    if (t + D_ < nt) load(t + D_, (t + D_) % S);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      cur[i] = 0.0f;
      // pinned before the products: a register write that the compiler
      // moved in among them would make ptxas run them one at a time
      asm volatile("" : "+f"(cur[i])::"memory");
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = k * 8;                  // 32 bytes of K a step
      const uint64_t wh = wgmma_desc(sw + o);
      const uint64_t xh = wgmma_desc(sw + kFcW + o);
      wgmma_64xn<float, NW>(cur, wgmma_desc(lo + o), xh);
      wgmma_64xn<float, NW>(cur, wh, wgmma_desc(lo + kFcW + o));
      wgmma_64xn<float, NW>(cur, wh, xh);
    }
    wgmma_commit();
    wgmma_wait_all_n<NW>(cur);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) d[i] += cur[i];
  }
  cp_async_wait<0>();
  __syncthreads();                          // the ring is free

  // the tile's logits, 64 vocab rows x 80 batch columns: accumulator j*4 +
  // i of (warp w, lane l) is row 16 w + l / 4 (+8 for i >= 2), column 8 j
  // + 2 (l % 4) + i % 2
  float* red = ring;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(16 * warp + lane / 4 + (i >= 2 ? 8 : 0)) * kFcLdr + 8 * j +
          2 * (lane % 4) + (i & 1)] = d[j * 4 + i];
  __syncthreads();

  // thread c < 80 folds batch column c (row b0 + c) over the tile's nv
  // words, in id order: the max, then the sum of exp(x - max) and a sorted
  // list of KT (value, id) pairs (a strictly greater value enters, so on a
  // tie the lower id stays ahead; empty slots are (-inf, INT_MAX)).  One
  // thread a column keeps the fold's chains independent: a warp a column
  // made each step wait on its shuffles.
  const int c = tid, nv = min(kFcM, a.V - v0);
  if (c >= NW || b0 + c >= a.R) return;
  float m = -INFINITY;
#pragma unroll 8
  for (int v = 0; v < nv; ++v) m = fmaxf(m, red[v * kFcLdr + c] + bias_s[v]);
  float lv[KT];
  int li[KT];
#pragma unroll
  for (int q = 0; q < KT; ++q) {
    lv[q] = -INFINITY;
    li[q] = INT_MAX;
  }
  float sum = 0.0f;
#pragma unroll 4
  for (int v = 0; v < nv; ++v) {
    const float x = red[v * kFcLdr + c] + bias_s[v];
    sum += expf(x - m);
    if (!(x > lv[KT - 1])) continue;
    bool placed = false;
#pragma unroll
    for (int p = KT - 1; p > 0; --p) {
      if (!placed) {
        if (x > lv[p - 1]) {
          lv[p] = lv[p - 1];
          li[p] = li[p - 1];
        } else {
          lv[p] = x;
          li[p] = v0 + v;
          placed = true;
        }
      }
    }
    if (!placed) {
      lv[0] = x;
      li[0] = v0 + v;
    }
  }
  const long long p = (long long)(b0 + c) * a.nt + vt;
  a.pm[p] = m;
  a.ps[p] = sum;
  const int kt = a.kt;
#pragma unroll
  for (int q = 0; q < KT; ++q) {
    if (q < kt) {
      a.pv[p * kt + q] = lv[q];
      a.pi[p * kt + q] = li[q];
    }
  }
}

// A warp a row: the row's lse and its k winners from its nt partials.
// Dynamic shared memory, per warp: a head index for each tile, and with
// stage the row's nt kt (value, id) pairs, copied in once (coalesced) so
// the rounds read them there.
__global__ void __launch_bounds__(kFcMergeWarps * 32)
    fc_merge_kernel(const float* __restrict__ pm, const float* __restrict__ ps,
                    const float* __restrict__ pv, const int* __restrict__ pi,
                    int R, int nt, int kt, int k, int stage,
                    float* __restrict__ topv, int* __restrict__ topi,
                    float* __restrict__ lse) {
  extern __shared__ int fc_merge_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kFcMergeWarps + warp;
  if (row >= R) return;
  const int n = nt * kt;
  int* hp = fc_merge_raw + warp * (stage ? nt + 2 * n : nt);
  const float* rm = pm + (long long)row * nt;
  const float* rs = ps + (long long)row * nt;
  const float* rv = pv + (long long)row * n;
  const int* ri = pi + (long long)row * n;
  if (stage) {
    float* sv = (float*)(hp + nt);
    int* si = hp + nt + n;
    for (int i = lane; i < n; i += 32) {
      sv[i] = rv[i];
      si[i] = ri[i];
    }
    rv = sv;
    ri = si;
  }
  float m = -INFINITY;
  for (int t = lane; t < nt; t += 32) m = fmaxf(m, rm[t]);
  m = warp_max(m);
  float s = 0.0f;
  for (int t = lane; t < nt; t += 32) s += rs[t] * expf(rm[t] - m);
  s = warp_sum(s);
  if (lane == 0) lse[row] = logf(s) + m;
  for (int t = lane; t < nt; t += 32) hp[t] = 0;
  __syncwarp();
  // this lane's best head over its tiles lane, lane + 32, ...
  float cv;
  int ci, ct;
  auto rescan = [&]() {
    cv = -INFINITY;
    ci = INT_MAX;
    ct = -1;
    for (int t = lane; t < nt; t += 32) {
      const int q = hp[t];
      if (q >= kt) continue;
      const float v = rv[t * kt + q];
      const int i = ri[t * kt + q];
      if (v > cv || (v == cv && i < ci)) {
        cv = v;
        ci = i;
        ct = t;
      }
    }
  };
  rescan();
  for (int q = 0; q < k; ++q) {
    float bv = cv;
    int bi = ci;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      topv[(long long)row * k + q] = bv;
      topi[(long long)row * k + q] = bi;
    }
    if (ct >= 0 && ci == bi) {   // this lane's head won: its next
      ++hp[ct];
      rescan();
    }
  }
}

static bool fc_plan_ok(const FcPlan& pl, int R, int V, int k) {
  return pl.nb == kFcNB && pl.nt == (V + kFcM - 1) / kFcM &&
         pl.bt == (R + kFcNB - 1) / kFcNB &&
         pl.kt == (k < kFcMaxKt ? k : kFcMaxKt) &&
         pl.smem == (long long)kFcSmem &&
         pl.merge_smem == (long long)kFcMergeWarps * 4 *
                              (pl.nt + (pl.stage ? 2 * pl.nt * pl.kt : 0)) &&
         pl.merge_smem <= 232448;
}

// The W map: w^T's (V rows, D values, ldw apart) 64-row x 128-byte boxes,
// kept by mma_small.cuh's descriptor cache.
static int fc_map(const void* wt, long long ldw, int V, int D,
                  CUtensorMap* map) {
  SmallProb p = {};
  small_src(p, nullptr, 0, wt, ldw, V, D);
  const int err = w_tensor_map<float, kSmWide>(p, 0);
  if (err == 0) *map = p.map[0];
  return err;
}

}  // namespace iic

// h (R, ldh), wt (V, ldw) the K-major pack of w (D values a row, ldw % 4
// == 0, 16-byte aligned), b (V,), all float32; part the partials' scratch,
// R nt (2 + 2 kt) words; topv (R, k) and lse (R,) float32, topi (R, k)
// int32; plan ops/fc_topk.py fc_plan's.  Returns the CUDA error code of
// the launches (0 on success).
extern "C" int iic_fc_topk(const void* h, long long ldh, const void* wt,
                           long long ldw, const void* b, void* part,
                           void* topv, void* topi, void* lse, int R, int D,
                           int V, int k, const void* plan, void* stream) {
  const iic::FcPlan& pl = *(const iic::FcPlan*)plan;
  if (R < 1 || D < 1 || k < 1 || k > V || ldw < D || ldw % 4 != 0 ||
      (uintptr_t)wt % 16 != 0 || ldh < D || !iic::fc_plan_ok(pl, R, V, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  iic::FcArgs a = {};
  int err = iic::fc_map(wt, ldw, V, D, &a.map);
  if (err != 0) return err;
  const long long n = (long long)R * pl.nt;
  a.h = (const float*)h;
  a.b = (const float*)b;
  a.pm = (float*)part;
  a.ps = a.pm + n;
  a.pv = a.ps + n;
  a.pi = (int*)(a.pv + n * pl.kt);
  a.ldh = ldh;
  a.R = R, a.D = D, a.V = V, a.nt = (int)pl.nt, a.kt = (int)pl.kt;
  a.h_al = (uintptr_t)h % 16 == 0 && ldh % 4 == 0;
  const int KT = pl.kt <= 8 ? 8 : pl.kt <= 16 ? 16 : pl.kt <= 32 ? 32 : 64;
  const dim3 grid((unsigned)pl.nt, (unsigned)pl.bt);
  switch (KT) {
#define IIC_FC_CASE(n)                                                      \
  case n: {                                                                 \
    static bool ready = false;   /* the attribute, once per instance */    \
    if (!ready) {                                                           \
      err = iic::allow_smem(iic::fc_tile_kernel<n>, iic::kFcSmem);          \
      if (err != 0) return err;                                             \
      ready = true;                                                         \
    }                                                                       \
    iic::fc_tile_kernel<n><<<grid, iic::kFcThreads, iic::kFcSmem, s>>>(a);  \
    break;                                                                  \
  }
    IIC_FC_CASE(8)
    IIC_FC_CASE(16)
    IIC_FC_CASE(32)
    IIC_FC_CASE(64)
#undef IIC_FC_CASE
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = iic::allow_smem(iic::fc_merge_kernel, (size_t)pl.merge_smem);
  if (err != 0) return err;
  iic::fc_merge_kernel<<<(R + iic::kFcMergeWarps - 1) / iic::kFcMergeWarps,
                         iic::kFcMergeWarps * 32, (size_t)pl.merge_smem, s>>>(
      a.pm, a.ps, a.pv, a.pi, R, (int)pl.nt, (int)pl.kt, k, (int)pl.stage,
      (float*)topv, (int*)topi, (float*)lse);
  return (int)cudaGetLastError();
}
