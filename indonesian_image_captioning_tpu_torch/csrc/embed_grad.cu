// Kernel 14: the embedding table's gradient, d_table[ids[n]] += g[n] over
// N = B * T caption tokens, into a (V, E) float32 table.
//
// Replaces indonesian_image_captioning_tpu/ops/embed_grad_pallas.py
// embed_grad_scatter (body _kernel).  The Pallas kernel contracts a
// one-hot tile against g on the MXU, because Mosaic cannot express a
// scatter into a row chosen by a token id; here the scatter is written
// directly.  Its contract holds: g float32 or bfloat16, accumulated in
// float32; ids outside [0, V) add nothing (the one-hot of such an id is
// zero), so padded rows with id 0 and zero g add nothing either.
//
// What bounds it: bytes.  The table is written once (V * E * 4: 13.85 MB
// at V = 6,763, E = 512) and g read once (N * E * isz: 3.34 MB at B = 32,
// 107 MB at B = 1,024), against one add per g element.
//
// What the design does about it.  A caption batch is mostly padding, so
// one id (0) owns most tokens: a design that adds an id's rows on one
// block, token after token, waits on that block.  Here the tokens are
// first sorted by id, stably, and the sorted list is then summed in short
// segments that all blocks share, in three or four launches with no float
// atomics:
//
//   1. hist (one block per chunk of about 1,024 tokens): a histogram of
//      the chunk's ids in shared memory, and each token's rank among the
//      earlier tokens of its chunk with the same id (warps in token order,
//      a match mask within each warp), so the integer counts are exact and
//      the ranks follow token order.  Ids outside [0, V) are dropped here.
//   2. scan (one block): per id, the exclusive prefix of the counts over
//      chunks and the id's total; the exclusive scan of the totals over
//      the vocabulary (each id's first place in the sorted list); each
//      id's count of finished segment blocks (step 4) set to zero.
//   3. scatter: the stable scatter of the token positions into the sorted
//      list, at start + chunk prefix + rank -- in step 2's block when N is
//      at most kScatterInScan (a launch saved), else one thread a token.
//   4. tail, one launch:
//      - segments (one block per seg places of the sorted list, 32 at
//        B = 32 and more as N grows, so a heavy id has fewer partials):
//        one pass over the block's rows sums each run of one id in list
//        order, eight rows' loads in flight, 16-byte loads where E and g
//        allow.  A run that is all of its id's tokens writes its table
//        row; the first run of a block (started before it) and the last
//        (going on after it) write their partial sums to scratch and
//        count the block done for their id (an integer atomic); the block
//        that finishes an id last adds the id's partials, in block order,
//        eight loads in flight (eight running sums by block index modulo
//        8, added in order at the end), into its table row.
//      - zero blocks (after the segment blocks): every row of an id with
//        no token is written as zeros.
//      Each table element is written once.
//
// The order of the sums is fixed -- tokens in order within a segment,
// segments in a fixed order -- so two calls are bitwise equal.  It is not
// token order across segments, nor the Pallas kernel's (an MXU
// contraction), so the contract with both is that determinism and a
// tolerance of 1e-6 of each column's sum of |g|.  The scratch (counts,
// ranks, the sorted list, the partials) comes from the wrapper
// (ops/embed_grad_cuda.py).
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace iic {

constexpr int kScanThreads = 1024;
constexpr int kMaxChunks = 16;    // token chunks of step 1
constexpr int kHistTile = 16384;  // ids per shared-memory histogram pass
constexpr int kSegMax = 256;      // sorted places per segment block, at most
constexpr int kSegThreads = 128;
constexpr int kZeroBlocks = 4 * 132;  // the tail's blocks of zero rows
constexpr int kScatterInScan = 16384;   // tokens step 2 scatters itself

struct EmbedScratch {
  int* hist;     // (nch, V): per-chunk counts, then their chunk prefix
  int* cnt;      // (V,) tokens per id
  int* start;    // (V,) the id's first place in the sorted list
  int* done;     // (V,) segment blocks finished with the id's partials
  int* rank;     // (N,) a token's rank among its chunk's tokens of its id
  int* sorted;   // (N,) token positions sorted by id, stably
  int* nv;       // (1,) tokens with an id in [0, V)
  float* part;   // (ceil(N / seg), 2, E) the segment blocks' partials
  int seg;       // sorted places per segment block (32 .. kSegMax)
};

// 1. Chunk c = blockIdx.x holds tokens [c * tc, min(N, (c + 1) * tc)).
__global__ void __launch_bounds__(kScanThreads)
embed_hist_kernel(const int* __restrict__ ids, int N, int V, int tc,
                  EmbedScratch s) {
  extern __shared__ int hist[];    // min(V, kHistTile)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x;
  const int n_lo = c * tc, n_hi = min(N, n_lo + tc);
  const unsigned lt = (1u << lane) - 1u;
  for (int v0 = 0; v0 < V; v0 += kHistTile) {
    const int vt = min(kHistTile, V - v0);
    for (int i = tid; i < vt; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int base = n_lo; base < n_hi; base += blockDim.x) {
      const int n = base + tid;
      const int id = n < n_hi ? ids[n] : -1;
      const bool mine = (unsigned)(id - v0) < (unsigned)vt &&
                        (unsigned)id < (unsigned)V;
      const unsigned m = __match_any_sync(0xffffffffu, mine ? id : -1);
      // warps in token order: each reads its ids' counts so far, then the
      // highest lane of each id's group adds the group's size
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        if (warp == w) {
          int seen = 0;
          if (mine) seen = hist[id - v0];
          __syncwarp();
          if (mine) {
            s.rank[n] = seen + __popc(m & lt);
            if (31 - __clz(m) == lane) hist[id - v0] = seen + __popc(m);
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < vt; i += blockDim.x)
      s.hist[(long long)c * V + v0 + i] = hist[i];
    __syncthreads();
  }
}

// Exclusive scan of one value per thread over the block; returns the
// thread's prefix and sets *total to the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();                        // warp_sums is reused
  return before;
}

// 3. The token's place in the sorted list.
__device__ __forceinline__ void scatter_one(const int* __restrict__ ids,
                                            int n, int V, int tc,
                                            const EmbedScratch& s) {
  const int id = ids[n];
  if ((unsigned)id >= (unsigned)V) return;
  const int c = n / tc;
  s.sorted[s.start[id] + s.hist[(long long)c * V + id] + s.rank[n]] = n;
}

// 2. One block; with N <= kScatterInScan, step 3 too.  In passes of
// kIdsPer * 1024 ids, thread t takes ids v0 + t + 1024 j (j < kIdsPer):
// their chunk prefixes with kIdsPer loads in flight (neighbouring
// threads, neighbouring ids), their totals kept in registers for the
// kIdsPer block scans over the vocabulary that follow.
__global__ void __launch_bounds__(kScanThreads)
embed_scan_kernel(const int* __restrict__ ids, int N, int V, int nch,
                  int tc, EmbedScratch s) {
  constexpr int kIdsPer = 8;
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x;
  int carry = 0;
  for (int v0 = 0; v0 < V; v0 += kIdsPer * kScanThreads) {
    int run[kIdsPer];
#pragma unroll
    for (int j = 0; j < kIdsPer; ++j) run[j] = 0;
    for (int c = 0; c < nch; ++c) {
      int* h = s.hist + (long long)c * V + v0 + tid;
      int x[kIdsPer];
#pragma unroll
      for (int j = 0; j < kIdsPer; ++j)
        x[j] = v0 + tid + j * kScanThreads < V ? h[j * kScanThreads] : 0;
#pragma unroll
      for (int j = 0; j < kIdsPer; ++j) {
        if (v0 + tid + j * kScanThreads < V) h[j * kScanThreads] = run[j];
        run[j] += x[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kIdsPer; ++j) {
      const int id = v0 + tid + j * kScanThreads;
      int total;
      const int before = block_exclusive_scan(run[j], warp_sums, &total);
      if (id < V) {
        s.cnt[id] = run[j];
        s.start[id] = carry + before;
        s.done[id] = 0;
      }
      carry += total;
    }
  }
  if (tid == 0) *s.nv = carry;
  if (N > kScatterInScan) return;
  __syncthreads();                      // start and the prefixes are here
  for (int n = tid; n < N; n += blockDim.x) scatter_one(ids, n, V, tc, s);
}

// 3. One thread per token, when N > kScatterInScan.
__global__ void embed_scatter_kernel(const int* __restrict__ ids, int N,
                                     int V, int tc, EmbedScratch s) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < N) scatter_one(ids, n, V, tc, s);
}

// W columns of row n of g, as float32 (W = 4: one 16-byte load at float32,
// 8 bytes at bfloat16; the caller checks alignment).
template <typename T, int W>
__device__ __forceinline__ void load_cols(const T* __restrict__ g, long long i,
                                          float* x);
template <>
__device__ __forceinline__ void load_cols<float, 4>(
    const float* __restrict__ g, long long i, float* x) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(g + i));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
template <>
__device__ __forceinline__ void load_cols<__nv_bfloat16, 4>(
    const __nv_bfloat16* __restrict__ g, long long i, float* x) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(g + i));
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
template <>
__device__ __forceinline__ void load_cols<float, 1>(
    const float* __restrict__ g, long long i, float* x) {
  x[0] = __ldg(g + i);
}
template <>
__device__ __forceinline__ void load_cols<__nv_bfloat16, 1>(
    const __nv_bfloat16* __restrict__ g, long long i, float* x) {
  x[0] = __bfloat162float(g[i]);
}

// Stores W sums at dst (16 bytes at W = 4).
template <int W>
__device__ __forceinline__ void store_cols(float* dst, const float* acc) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  else
    dst[0] = acc[0];
}

// Adds id's partials (segment blocks b0 .. b1 of the sorted list) into
// its table row, W columns a thread: block b0's last run, then each later
// block's first run, kAhead loads in flight (kAhead running sums by block
// index modulo kAhead, then added in order).  The partials come from L2:
// other blocks wrote them.
template <int W>
__device__ __forceinline__ void combine_row(int id, int E, float* out,
                                            const EmbedScratch& s) {
  constexpr int kAhead = 8;
  const int lo = s.start[id], hi = lo + s.cnt[id];
  const int b0 = lo / s.seg, b1 = (hi - 1) / s.seg;
  for (int col = threadIdx.x * W; col < E; col += blockDim.x * W) {
    auto part = [&](int b) {
      return s.part + ((long long)b * 2 + (b == b0 ? 1 : 0)) * E + col;
    };
    float lane[kAhead][W];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int w = 0; w < W; ++w) lane[u][w] = 0.0f;
    for (int b = b0; b <= b1; b += kAhead) {
      float x[kAhead][W];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
#pragma unroll
        for (int w = 0; w < W; ++w)
          x[u][w] = b + u <= b1 ? __ldcg(part(b + u) + w) : 0.0f;
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
#pragma unroll
        for (int w = 0; w < W; ++w) lane[u][w] += x[u][w];
    }
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.0f;
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] += lane[u][w];
    store_cols<W>(out + (long long)id * E + col, acc);
  }
}

// 4. The tail.  Block b < seg_blocks sums places [b * seg, min(nv, (b + 1)
// * seg)) of the sorted list, W columns a thread at a time, in one pass
// over the block's rows: kAhead rows' loads in flight, the running sum
// stored where the id changes; then counts itself done for the ids whose
// partials it wrote, and the block that finishes an id last writes its
// row (combine_row).  The blocks after them write the zero rows.
template <typename T, int W>
__global__ void __launch_bounds__(kSegThreads)
embed_segment_kernel(const int* __restrict__ ids, const T* __restrict__ g,
                     int V, int E, int seg_blocks, float* __restrict__ out,
                     EmbedScratch s) {
  constexpr int kAhead = 8;
  __shared__ int tok[kSegMax];
  __shared__ int sid[kSegMax];
  __shared__ long long dst_of[kSegMax];  // where the run starting here goes
  __shared__ int s_last[2];              // ids this block finishes, or -1
  const int b = blockIdx.x, tid = threadIdx.x;
  if (b >= seg_blocks) {                 // a zero block
    const int per_row = E / W;
    const long long n = (long long)V * per_row;
    const float zero[W] = {};
    for (long long idx = (long long)(b - seg_blocks) * blockDim.x + tid;
         idx < n; idx += (long long)(gridDim.x - seg_blocks) * blockDim.x) {
      const int id = (int)(idx / per_row);
      if (s.cnt[id] == 0)
        store_cols<W>(out + (long long)id * E + (idx % per_row) * W, zero);
    }
    return;
  }
  const int p0 = b * s.seg;
  const int nv = *s.nv;
  if (p0 >= nv) return;
  const int np = min(s.seg, nv - p0);
  for (int q = tid; q < np; q += kSegThreads) {
    const int n = s.sorted[p0 + q];
    const int id = ids[n];
    const int lo = s.start[id], hi = lo + s.cnt[id];
    tok[q] = n;
    sid[q] = id;
    // all of the id here: its table row; the first run (started before
    // the block): partial slot 0; the last (going on after it): slot 1
    dst_of[q] = (lo >= p0 && hi <= p0 + np)
                    ? -1 - (long long)id * E
                    : ((long long)b * 2 + (lo < p0 ? 0 : 1)) * E;
  }
  __syncthreads();
  auto dst = [&](int q) {
    const long long d = dst_of[q];
    return d < 0 ? out + (-1 - d) : s.part + d;
  };
  for (int col = tid * W; col < E; col += kSegThreads * W) {
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.0f;
    int run = 0;                                  // the run's first row
    for (int q0 = 0; q0 < np; q0 += kAhead) {
      float x[kAhead][W];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (q0 + u < np)
          load_cols<T, W>(g, (long long)tok[q0 + u] * E + col, x[u]);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int q = q0 + u;
        if (q >= np) break;
        if (sid[q] != sid[run]) {
          store_cols<W>(dst(run) + col, acc);
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] = 0.0f;
          run = q;
        }
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] += x[u][w];
      }
    }
    store_cols<W>(dst(run) + col, acc);
  }

  // The partial ids: the first run's and, when another, the last run's.
  // Every thread's partial stores reach L2 before the count moves.
  __threadfence();
  __syncthreads();
  if (tid < 2) {
    const int q = tid == 0 ? 0 : np - 1;
    int id = dst_of[q] >= 0 && (tid == 0 || sid[q] != sid[0]) ? sid[q] : -1;
    if (id >= 0) {
      const int lo = s.start[id], hi = lo + s.cnt[id];
      const int blocks = (hi - 1) / s.seg - lo / s.seg + 1;
      if (atomicAdd(&s.done[id], 1) != blocks - 1) id = -1;
    }
    s_last[tid] = id;
  }
  __syncthreads();
  for (int t = 0; t < 2; ++t) {
    if (s_last[t] < 0) continue;
    __threadfence();
    combine_row<W>(s_last[t], E, out, s);
  }
}

template <typename T, int W>
static int launch_tail(const int* ids, const T* g, int N, int V, int E,
                       float* out, const EmbedScratch& s, cudaStream_t st) {
  const int seg_blocks = (N + s.seg - 1) / s.seg;
  embed_segment_kernel<T, W><<<seg_blocks + kZeroBlocks, kSegThreads, 0,
                               st>>>(ids, g, V, E, seg_blocks, out, s);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_embed_grad(const int* ids, const T* g, int N, int V, int E,
                             int nch, float* out, const EmbedScratch& s,
                             cudaStream_t st) {
  if (N > 0) {
    const int tc = (N + nch - 1) / nch;
    const size_t smem = sizeof(int) * (size_t)std::min(V, kHistTile);
    int err = allow_smem(embed_hist_kernel, smem);
    if (err != 0) return err;
    embed_hist_kernel<<<nch, kScanThreads, smem, st>>>(ids, N, V, tc, s);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    embed_scan_kernel<<<1, kScanThreads, 0, st>>>(ids, N, V, nch, tc, s);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    if (N > kScatterInScan) {
      embed_scatter_kernel<<<(N + 255) / 256, 256, 0, st>>>(ids, N, V, tc,
                                                            s);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  } else {
    // no token: every count is 0 and every row is written as zeros
    const int err = (int)cudaMemsetAsync(s.cnt, 0, sizeof(int) * V, st);
    if (err != 0) return err;
  }
  // 16-byte loads of g and stores of the table where E and the pointers
  // allow (every row then starts on a 16-byte boundary)
  const bool vec = E % 4 == 0 && (uintptr_t)out % 16 == 0 &&
                   (uintptr_t)s.part % 16 == 0 &&
                   (uintptr_t)g % (4 * sizeof(T)) == 0;
  if (vec) return launch_tail<T, 4>(ids, g, N, V, E, out, s, st);
  return launch_tail<T, 1>(ids, g, N, V, E, out, s, st);
}

}  // namespace iic

// ids (N,) int32; g (N, E) in the dtype's storage, row-major; out (V, E)
// float32, every element written.  nch: the token chunks of step 1 (1 ..
// min(16, N)); seg: sorted places per segment block (a multiple of 32, at
// most 256); scratch: ceil(N / seg) * 2 * E float32 (16-byte aligned),
// then nch * V + 3 * V + 2 * N + 1 int32 (ops/embed_grad_cuda.py sizes it).
// Returns the first failing launch's CUDA error code, 0 on success.
extern "C" int iic_embed_grad(int dtype, const void* ids, const void* g,
                              int N, int V, int E, int nch, int seg,
                              void* scratch, void* out, void* stream) {
  if (N < 0 || V < 1 || E < 1 || nch < 1 || nch > iic::kMaxChunks ||
      (N > 0 && nch > N) || seg < 32 || seg > iic::kSegMax || seg % 32)
    return (int)cudaErrorInvalidValue;
  iic::EmbedScratch s;
  s.seg = seg;
  s.part = (float*)scratch;
  const long long parts = (long long)((N + seg - 1) / seg) * 2 * E;
  int* p = (int*)(s.part + parts);
  s.hist = p;
  p += (long long)nch * V;
  s.cnt = p;
  s.start = p + V;
  s.done = p + 2 * V;
  s.rank = p + 3 * V;
  s.sorted = p + 3 * V + N;
  s.nv = p + 3 * V + 2 * N;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::launch_embed_grad<float>((const int*)ids, (const float*)g, N,
                                         V, E, nch, (float*)out, s, st);
  if (dtype == iic::kBF16)
    return iic::launch_embed_grad<__nv_bfloat16>(
        (const int*)ids, (const __nv_bfloat16*)g, N, V, E, nch, (float*)out,
        s, st);
  return (int)cudaErrorInvalidValue;
}
