// The latent-attention / mixture-of-experts caption decoder's kernels
// (ops/lm_cuda.py; models/kimi_lm.py, Kimi-VL-A3B's language model).  All
// bf16 storage, float32 arithmetic; ids and routing scores never go
// through a reduced-precision product.
//
//   iic_lm_gemm         the dense products on mma.cuh's tensor-core GEMM
//                       (launch_gemm_tc: its persistent kernel where the
//                       128 x 128 tiles fill the card), z-sliced for the
//                       absorbed attention's per-head products
//   iic_lm_rmsnorm      DeepSeek's RMSNorm, a block a row
//   iic_lm_latent_rope  the cache row of a token: the latent RMSNormed,
//                       the shared rotary key rotated; the queries' rope
//                       parts rotated in place (the published layout:
//                       pairs de-interleaved, then rotate_half)
//   iic_lm_mla_decode   the decode's attention, absorbed: a block an image
//                       (below)
//   iic_lm_router       float32 router logits (FFMA, 8 or 16 tokens a
//                       block, H split over its warps), sigmoid scores, the top k
//                       of score + bias (the lowest id first among equal
//                       values), the unbiased weights normalised, scaled
//   iic_lm_moe_dispatch a counting sort of the (token, expert) pairs into
//                       the groups' blocks, each padded to 128 rows (the
//                       grouped GEMM's row tile), in token order within a
//                       group; the shared expert's groups take every token
//   iic_lm_moe_gather   the rows of the blocks, zeros on padding
//   iic_lm_grouped_gemm mma.cuh's grouped mode: gate and up with SiLU x up
//                       in the epilogue, then down times the routing weight
//   iic_lm_moe_combine  a token's rows summed in a fixed order, float32,
//                       with the residual, rounded once
//   iic_lm_swiglu       the dense MLP's SiLU x up
//   iic_lm_head_topk    step.cuh's head_topk_kernel (raw: log-probabilities)
//
// The MLA decode.  R = B K lanes, 16 heads a lane; the cache holds a
// position's latent (r = 512) and rotary key (dr = 64), 576 bf16.  A block
// takes up to five lanes of one image (mla_decode_kernel below): the
// prefix's scores and P V on the tensor cores (wmma 16 x 16 x 16, bf16,
// float32 sums), each fragment of the image's prefix loaded once for all
// its lanes, so the prefix is read once an image for its scores and once
// for P V; each lane's suffix (at most 64 positions) through the slot
// table on the CUDA cores; the softmax in float32 over prefix and suffix
// (scale (dn + dr)^-0.5), P rounded to bf16, the latent output (16, 512)
// rounded once.  What bounds it: the bytes, the prefix (197 x 576 x 2 B)
// an image and each lane's suffix, 1.6 GB a step at B = 256 over 27
// layers; the operations (9.5 MFLOP a lane a layer) are few.
#include <cstdint>

#include <mma.h>

#include "mma.cuh"
#include "step.cuh"

namespace iic {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- rmsnorm ----

constexpr int kNormThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) red[w] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// y = w * bf16(x / sqrt(mean(x^2) + eps)), rounded to bf16.
__device__ __forceinline__ void norm_row(const bf16* x, const bf16* w,
                                         bf16* y, int n, float eps,
                                         float* red) {
  float ss = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = to_f(x[i]);
    ss += v * v;
  }
  const float inv = rsqrtf(block_sum(ss, red) / n + eps);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    y[i] = __float2bfloat16(to_f(w[i]) * rt<bf16>(to_f(x[i]) * inv));
}

__global__ void __launch_bounds__(kNormThreads)
    rmsnorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ y, int n, float eps) {
  __shared__ float red[32];
  const long long r = blockIdx.x;
  norm_row(x + r * n, w, y + r * n, n, eps, red);
}

// The rotary embedding of d values at p (in place): the pairs
// de-interleaved, then x cos + rotate_half(x) sin, by the threads of a
// warp (d <= 64).
__device__ __forceinline__ void rope_warp(bf16* p, const float* cos,
                                          const float* sin, int d) {
  const int l = threadIdx.x & 31, h = d / 2;
  float a[2], b[2];
  for (int u = 0; u < 2; ++u) {
    const int i = l + 32 * u;      // the de-interleaved index
    if (i < d) {
      a[u] = to_f(p[i < h ? 2 * i : 2 * (i - h) + 1]);
      b[u] = to_f(p[i < h ? 2 * i + 1 : 2 * (i - h)]);   // its partner
    }
  }
  __syncwarp();
  for (int u = 0; u < 2; ++u) {
    const int i = l + 32 * u;
    if (i < d) {
      const float rot = i < h ? -b[u] : b[u];
      p[i] = __float2bfloat16(a[u] * cos[i] + rot * sin[i]);
    }
  }
  __syncwarp();
}

// A block a token: out = [rmsnorm(kva[:r]) | rope(kva[r:])]; the rope part
// of each of the nh heads of q rotated in place.
__global__ void __launch_bounds__(kNormThreads)
    latent_rope_kernel(bf16* __restrict__ q, long long ldq,
                       const bf16* __restrict__ kva,
                       const bf16* __restrict__ norm_w,
                       const float* __restrict__ cos,
                       const float* __restrict__ sin, long long ldcs,
                       bf16* __restrict__ out, int nh, int dq, int dr, int r,
                       float eps) {
  __shared__ float red[32];
  const long long n = blockIdx.x;
  const int D = r + dr;
  norm_row(kva + n * D, norm_w, out + n * D, r, eps, red);
  const float* c = cos + n * ldcs;
  const float* s = sin + n * ldcs;
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (w == 0) {
    for (int i = threadIdx.x; i < dr; i += 32)
      out[n * D + r + i] = kva[n * D + r + i];
    __syncwarp();
    rope_warp(out + n * D + r, c, s, dr);
  }
  for (int h = w; h < nh; h += nw)
    rope_warp(q + n * ldq + (long long)h * dq + dq - dr, c, s, dr);
}

// ------------------------------------------------------------ the MLA ----

namespace wm = nvcuda::wmma;
constexpr int kMlaThreads = 512, kMlaWarps = 16;
constexpr int kMlaH = 16, kMlaR = 512, kMlaDr = 64, kMlaD = 576;
constexpr int kMlaSuf = 64;              // suffix positions a lane, at most
constexpr int kMlaKt = kMlaD / 16;       // k tiles of a score
constexpr int kMlaLanes = 5;             // lanes a block

struct MlaArgs {
  const bf16* qlat;      // (R, 16, 512)
  const bf16* q;         // (R, ldq): head h's rope part at h dq + dq - 64
  long long ldq;
  const bf16* prefix;    // (B, Pc, 576)
  int Pc, P;
  const bf16* slots;     // (S, 576)
  const int* table;      // (R, ldt)
  long long ldt;
  const int* lens;       // (R,) or null: n_suf for every lane
  int n_suf;
  bf16* out;             // (R, 16, 512)
  int B, K, dq;
  float scale;
};

// Scores (then P, bf16, over the first half of each row) of the block's
// lanes: rows lane * 16 + head, Pc prefix columns then kMlaSuf suffix
// columns; one lane's suffix rows (latent part) gathered; a warp's 16 x 16
// staging; the lanes' slots.
static size_t mla_smem(int Pc) {
  return (size_t)kMlaLanes * kMlaH * (Pc + kMlaSuf) * 4 +
         (size_t)kMlaLanes * kMlaH * kMlaD * 2 + (size_t)kMlaWarps * 256 * 4 +
         (size_t)kMlaLanes * kMlaSuf * 4 + 64;
}

// A block takes up to five lanes of one image (blockIdx.y the group); its
// queries ([latent | rope], 576 a head) are staged in shared memory:
//   1. prefix scores on the tensor cores, a 16-position tile a warp, the
//      tile's fragments loaded once for all the block's lanes, four k
//      steps' loads in flight;
//   2. suffix scores on the CUDA cores, a warp a (lane, half of the heads),
//      reading the lane's slot rows two at a time;
//   3. the softmax, float32, a warp a row; P in bf16 over the row's start;
//   4. P V on the tensor cores, two 16-column tiles of the output a warp,
//      the sums of every lane kept in registers: the prefix's V fragments
//      loaded once for all lanes, then lane by lane its suffix rows
//      gathered through the slot table into shared memory (over the
//      queries) and added; each output rounded once.
__global__ void __launch_bounds__(kMlaThreads, 1)
    mla_decode_kernel(const __grid_constant__ MlaArgs a) {
  extern __shared__ __align__(128) unsigned char mla_smem_raw[];
  const int b = blockIdx.x, Pc = a.Pc, ldS = Pc + kMlaSuf;
  const int k0 = blockIdx.y * kMlaLanes, nk = min(kMlaLanes, a.K - k0);
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  float* sc = (float*)mla_smem_raw;                         // (80, ldS)
  bf16* qs = (bf16*)(sc + (size_t)kMlaLanes * kMlaH * ldS); // (80, 576)
  bf16* g = qs;                              // (64, 512), after the scores
  float* stage = (float*)(qs + kMlaLanes * kMlaH * kMlaD) + warp * 256;
  int* slot = (int*)((float*)(qs + kMlaLanes * kMlaH * kMlaD) +
                     kMlaWarps * 256);                      // (5, 64)
  __shared__ int len[kMlaLanes];
  const bf16* pre = a.prefix + (size_t)b * Pc * kMlaD;
  const int lane0 = b * a.K + k0;
  if (threadIdx.x < kMlaLanes)
    len[threadIdx.x] = threadIdx.x < nk
                           ? (a.lens ? a.lens[lane0 + threadIdx.x] : a.n_suf)
                           : 0;
  for (int i = threadIdx.x; i < kMlaLanes * kMlaSuf; i += kMlaThreads) {
    const int k = i / kMlaSuf, j = i % kMlaSuf;
    slot[i] = k < nk && j < a.ldt ? a.table[(lane0 + k) * a.ldt + j] : 0;
  }
  for (int c = threadIdx.x; c < nk * kMlaH * (kMlaD / 8); c += kMlaThreads) {
    const int row = c / (kMlaD / 8), e = 8 * (c % (kMlaD / 8));
    const long long r = lane0 + row / kMlaH;
    const int h = row % kMlaH;
    const bf16* src =
        e < kMlaR ? a.qlat + (r * kMlaH + h) * kMlaR + e
                  : a.q + r * a.ldq + (long long)h * a.dq + a.dq - kMlaDr +
                        (e - kMlaR);
    *(uint4*)(qs + row * kMlaD + e) = *(const uint4*)src;
  }
  __syncthreads();

  // 1. prefix scores
  for (int pt = warp; pt < Pc / 16; pt += kMlaWarps) {
    wm::fragment<wm::accumulator, 16, 16, 16, float> acc[kMlaLanes];
#pragma unroll
    for (int k = 0; k < kMlaLanes; ++k) wm::fill_fragment(acc[k], 0.0f);
    const bf16* kp = pre + (size_t)pt * 16 * kMlaD;
    for (int kt = 0; kt < kMlaKt; kt += 4) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> kf[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wm::load_matrix_sync(kf[u], kp + (kt + u) * 16, kMlaD);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < kMlaLanes; ++k) {
          if (k < nk) {
            wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> qf;
            wm::load_matrix_sync(qf, qs + k * kMlaH * kMlaD + (kt + u) * 16,
                                 kMlaD);
            wm::mma_sync(acc[k], qf, kf[u], acc[k]);
          }
        }
    }
#pragma unroll
    for (int k = 0; k < kMlaLanes; ++k)
      if (k < nk)
        wm::store_matrix_sync(sc + (size_t)k * kMlaH * ldS + pt * 16, acc[k],
                              ldS, wm::mem_row_major);
  }

  // 2. suffix scores: warp unit u = (lane, half of the heads)
  for (int u = warp; u < 2 * nk; u += kMlaWarps) {
    const int k = u / 2, h0 = 8 * (u % 2), n = len[k];
    const bf16* qk = qs + (k * kMlaH + h0) * kMlaD;
    for (int i0 = 0; i0 < n; i0 += 2) {    // two rows' loads in flight
      const int i1 = min(i0 + 1, n - 1);
      const bf16* r0 = a.slots + (long long)slot[k * kMlaSuf + i0] * kMlaD;
      const bf16* r1 = a.slots + (long long)slot[k * kMlaSuf + i1] * kMlaD;
      __nv_bfloat162 x0[9], x1[9];
#pragma unroll
      for (int v = 0; v < 9; ++v) {
        x0[v] = *(const __nv_bfloat162*)(r0 + 2 * (l + 32 * v));
        x1[v] = *(const __nv_bfloat162*)(r1 + 2 * (l + 32 * v));
      }
      float d0[8] = {0, 0, 0, 0, 0, 0, 0, 0}, d1[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int v = 0; v < 9; ++v) {
        const float2 a0 = __bfloat1622float2(x0[v]);
        const float2 a1 = __bfloat1622float2(x1[v]);
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          const float2 q2 = __bfloat1622float2(
              *(const __nv_bfloat162*)(qk + h * kMlaD + 2 * (l + 32 * v)));
          d0[h] += a0.x * q2.x + a0.y * q2.y;
          d1[h] += a1.x * q2.x + a1.y * q2.y;
        }
      }
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const float e0 = warp_sum(d0[h]), e1 = warp_sum(d1[h]);
        if (l == 0) {
          float* sr = sc + (size_t)(k * kMlaH + h0 + h) * ldS + Pc;
          sr[i0] = e0;
          sr[i1] = e1;
        }
      }
    }
  }
  __syncthreads();

  // 3. softmax, a warp a row; P (bf16) over the row's first half
  for (int row = warp; row < nk * kMlaH; row += kMlaWarps) {
    float* sr = sc + (size_t)row * ldS;
    const int n = len[row / kMlaH];
    float v[(208 + kMlaSuf + 31) / 32 + 1];
    float m = -INFINITY;
    int c = 0;
    for (int i = l; i < ldS; i += 32, ++c) {
      const bool on = i < a.P || (i >= Pc && i - Pc < n);
      v[c] = on ? sr[i] * a.scale : -INFINITY;
      m = fmaxf(m, v[c]);
    }
    m = warp_max(m);
    float sum = 0.0f;
    c = 0;
    for (int i = l; i < ldS; i += 32, ++c) {
      v[c] = v[c] == -INFINITY ? 0.0f : expf(v[c] - m);
      sum += v[c];
    }
    const float inv = 1.0f / warp_sum(sum);
    __syncwarp();
    bf16* pr = (bf16*)sr;
    c = 0;
    for (int i = l; i < ldS; i += 32, ++c) pr[i] = __float2bfloat16(v[c] * inv);
  }
  __syncthreads();

  // 4. P V: output tiles 2 warp .. 2 warp + 1 of every lane
  const int ldP = 2 * ldS;                 // P's row stride in bf16
  const bf16* pm = (const bf16*)sc;
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[kMlaLanes][2];
#pragma unroll
  for (int k = 0; k < kMlaLanes; ++k) {
    wm::fill_fragment(acc[k][0], 0.0f);
    wm::fill_fragment(acc[k][1], 0.0f);
  }
  for (int pt = 0; pt < Pc / 16; pt += 2) {    // four V loads in flight
    const int np = min(2, Pc / 16 - pt);
    wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> vf[2][2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (p < np)
          wm::load_matrix_sync(vf[p][t], pre + (size_t)(pt + p) * 16 * kMlaD +
                                             (2 * warp + t) * 16, kMlaD);
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int k = 0; k < kMlaLanes; ++k) {
        if (p < np && k < nk) {
          wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> pf;
          wm::load_matrix_sync(pf, pm + (size_t)k * kMlaH * ldP +
                                       (pt + p) * 16, ldP);
          wm::mma_sync(acc[k][0], pf, vf[p][0], acc[k][0]);
          wm::mma_sync(acc[k][1], pf, vf[p][1], acc[k][1]);
        }
      }
  }
#pragma unroll
  for (int k = 0; k < kMlaLanes; ++k) {
    if (k >= nk) break;
    const int n = len[k], tiles = (n + 15) / 16;
    __syncthreads();                       // the last lane's rows are read
    for (int c = threadIdx.x; c < tiles * 16 * (kMlaR / 8);
         c += kMlaThreads) {
      const int i = c / (kMlaR / 8), j = c % (kMlaR / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (i < n)
        v = *(const uint4*)(a.slots + (long long)slot[k * kMlaSuf + i] *
                                          kMlaD + 8 * j);
      *(uint4*)(g + i * kMlaR + 8 * j) = v;
    }
    __syncthreads();
    for (int st = 0; st < tiles; ++st) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> pf;
      wm::load_matrix_sync(pf, pm + (size_t)k * kMlaH * ldP + Pc + st * 16,
                           ldP);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> vf;
        wm::load_matrix_sync(vf, g + st * 16 * kMlaR + (2 * warp + t) * 16,
                             kMlaR);
        wm::mma_sync(acc[k][t], pf, vf, acc[k][t]);
      }
    }
  }
  const int h = l / 2, c0 = (l % 2) * 8;
#pragma unroll
  for (int k = 0; k < kMlaLanes; ++k) {
    if (k >= nk) break;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      wm::store_matrix_sync(stage, acc[k][t], 16, wm::mem_row_major);
      __syncwarp();
      __align__(16) bf16 ov[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        ov[u] = __float2bfloat16(stage[h * 16 + c0 + u]);
      *(uint4*)(a.out + ((size_t)(lane0 + k) * kMlaH + h) * kMlaR +
                (2 * warp + t) * 16 + c0) = *(const uint4*)ov;
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------- the router ----

constexpr int kRtE = 64;

// A block TOK tokens (8 at a decode step's rows, 16 at a prefill's):
// logits (TOK, E) = x (TOK, H) . w (E, H)^T in float32 -- warp w sums the
// w-th eighth of H, lane l experts l and l + 32, four columns a step (no
// barrier inside the sums); the warps' partial sums added in shared
// memory -- then a warp a token: sigmoid scores, k rounds of the largest
// score + bias (lowest id among equal values), the chosen unbiased scores
// normalised (+1e-20) and scaled.
template <int TOK>
__global__ void __launch_bounds__(256)
    router_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, int N, int H, int E, int k,
                  int norm, float scale, int* __restrict__ ids,
                  float* __restrict__ wts) {
  __shared__ float part[8][TOK][kRtE];
  __shared__ float lg[TOK][kRtE + 1];
  const int t0 = blockIdx.x * TOK, tid = threadIdx.x;
  const int warp = tid >> 5, l = tid & 31;
  const int span = H / 8, c0 = warp * span;
  const float* w0 = w + (long long)min(l, E - 1) * H;
  const float* w1 = w + (long long)min(l + 32, E - 1) * H;
  float acc[TOK][2] = {};
#pragma unroll 4
  for (int c = c0; c < c0 + span; c += 4) {
    const float4 a0 = *(const float4*)(w0 + c);
    const float4 a1 = *(const float4*)(w1 + c);
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      const int tok = min(t0 + t, N - 1);
      const uint2 raw = *(const uint2*)(x + (long long)tok * H + c);
      const float2 xa = __bfloat1622float2(*(const __nv_bfloat162*)&raw.x);
      const float2 xb = __bfloat1622float2(*(const __nv_bfloat162*)&raw.y);
      acc[t][0] += xa.x * a0.x + xa.y * a0.y + xb.x * a0.z + xb.y * a0.w;
      acc[t][1] += xa.x * a1.x + xa.y * a1.y + xb.x * a1.z + xb.y * a1.w;
    }
  }
#pragma unroll
  for (int t = 0; t < TOK; ++t) {
    part[warp][t][l] = acc[t][0];
    part[warp][t][l + 32] = acc[t][1];
  }
  __syncthreads();
  for (int i = tid; i < TOK * kRtE; i += 256) {
    const int t = i / kRtE, e = i % kRtE;
    float v = 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) v += part[u][t][e];
    lg[t][e] = v;
  }
  __syncthreads();
  for (int tt = warp; tt < TOK; tt += 8) {
    const int t = t0 + tt;
    if (t >= N) break;
    float s[2], c[2];
    for (int u = 0; u < 2; ++u) {
      const int e = l + 32 * u;
      s[u] = e < E ? 1.0f / (1.0f + expf(-lg[tt][e])) : 0.0f;
      c[u] = e < E ? s[u] + bias[e] : -INFINITY;
    }
    float total = 0.0f, mine = 0.0f;
    int pick = -1;
    for (int q = 0; q < k; ++q) {
      float bv = c[0] >= c[1] ? c[0] : c[1];    // ties: the lower id
      int bi = c[0] >= c[1] ? l : l + 32;
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      const float sv = __shfl_sync(0xffffffffu, s[bi >= 32], bi % 32);
      total += sv;
      if (l == q) {
        pick = bi;
        mine = sv;
      }
      if (bi % 32 == l) c[bi >= 32] = -INFINITY;
    }
    if (l < k) {
      float wv = norm ? mine / (total + 1e-20f) : mine;
      ids[(long long)t * k + l] = pick;
      wts[(long long)t * k + l] = wv * scale;
    }
  }
}

// --------------------------------------------------------- the dispatch ----

constexpr int kDispThreads = 1024, kDispMaxG = 128;

// One block.  counts; each group's block start (padded to bm rows); the
// row tiles' group and live end; pos (N, k + S) the row of every (token,
// slot) (slots k .. the shared groups); src (the token of a row, -1 on
// padding) and scale (the routing weight, 1 for shared, 0 on padding).
// Ranks within a group follow the flat order token * k + slot: a chunk of
// 1024 pairs at a time, a warp's equal ids by __match_any_sync, the warps'
// counts scanned per group.
__global__ void __launch_bounds__(kDispThreads)
    dispatch_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                    int N, int k, int E, int G, int bm, int cap,
                    int* __restrict__ counts, int* __restrict__ tile_group,
                    int* __restrict__ tile_end, int* __restrict__ ntiles,
                    int* __restrict__ pos, int* __restrict__ src,
                    float* __restrict__ scale) {
  __shared__ int cnt[kDispMaxG], start[kDispMaxG], run[kDispMaxG];
  __shared__ int wc[32][kDispMaxG];
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
  const int S = G - E, width = k + S;
  for (int g = tid; g < G; g += blockDim.x) {
    cnt[g] = g < E ? 0 : N;
    run[g] = 0;
  }
  __syncthreads();
  for (int i = tid; i < N * k; i += blockDim.x) atomicAdd(&cnt[ids[i]], 1);
  __syncthreads();
  if (tid == 0) {
    int off = 0, t = 0;
    for (int g = 0; g < G; ++g) {
      start[g] = off;
      counts[g] = cnt[g];
      const int blocks = (cnt[g] + bm - 1) / bm;
      for (int u = 0; u < blocks; ++u, ++t) {
        tile_group[t] = g;
        tile_end[t] = off + cnt[g];
      }
      off += blocks * bm;
    }
    *ntiles = t;
  }
  __syncthreads();
  // padding rows, then the shared groups' rows
  for (int g = 0; g < G; ++g) {
    const int lo = start[g] + cnt[g], hi = start[g] + (cnt[g] + bm - 1) / bm
                                                      * bm;
    for (int i = lo + tid; i < hi; i += blockDim.x) {
      src[i] = -1;
      scale[i] = 0.0f;
    }
  }
  for (int s = 0; s < S; ++s)
    for (int t = tid; t < N; t += blockDim.x) {
      const int row = start[E + s] + t;
      pos[(long long)t * width + k + s] = row;
      src[row] = t;
      scale[row] = 1.0f;
    }
  const unsigned lt = (1u << l) - 1u;
  for (int c0 = 0; c0 < N * k; c0 += blockDim.x) {
    for (int i = tid; i < 32 * kDispMaxG; i += blockDim.x)
      wc[i / kDispMaxG][i % kDispMaxG] = 0;
    __syncthreads();
    const int i = c0 + tid;
    const int e = i < N * k ? ids[i] : -1 - l;   // unmatched when idle
    const unsigned same = __match_any_sync(0xffffffffu, e);
    const int wrank = __popc(same & lt);
    if (e >= 0 && wrank == 0) wc[warp][e] = __popc(same);
    __syncthreads();
    for (int g = tid; g < E; g += blockDim.x) {
      int off = run[g];
      for (int u = 0; u < 32; ++u) {
        const int v = wc[u][g];
        wc[u][g] = off;
        off += v;
      }
      run[g] = off;
    }
    __syncthreads();
    if (e >= 0) {
      const int row = start[e] + wc[warp][e] + wrank;
      const int t = i / k, j = i % k;
      pos[(long long)t * width + j] = row;
      src[row] = t;
      scale[row] = w[i];
    }
    __syncthreads();
  }
}

// The blocks' rows: a[row] = x[src[row]], zeros where src is -1, for the
// rows of the filled tiles.
__global__ void gather_kernel(const bf16* __restrict__ x,
                              const int* __restrict__ src,
                              const int* __restrict__ ntiles, int bm, int H,
                              bf16* __restrict__ a) {
  const long long rows = (long long)__ldg(ntiles) * bm, per = H / 8;
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       c < rows * per; c += (long long)gridDim.x * blockDim.x) {
    const long long row = c / per, j = c % per;
    const int s = src[row];
    uint4 v = make_uint4(0, 0, 0, 0);
    if (s >= 0) v = *(const uint4*)(x + (long long)s * H + 8 * j);
    *(uint4*)(a + row * H + 8 * j) = v;
  }
}

// out[t] = bf16(resid[t] + sum_j y[pos[t, j]]), j in order, float32; a
// block a token, four columns a thread at a time.
__global__ void combine_kernel(const float* __restrict__ y,
                               const int* __restrict__ pos, int width, int H,
                               const bf16* __restrict__ resid,
                               bf16* __restrict__ out) {
  const long long t = blockIdx.x;
  for (int c = 4 * threadIdx.x; c < H; c += 4 * blockDim.x) {
    float4 s = make_float4(0, 0, 0, 0);
    if (resid) {
      s.x = to_f(resid[t * H + c]);
      s.y = to_f(resid[t * H + c + 1]);
      s.z = to_f(resid[t * H + c + 2]);
      s.w = to_f(resid[t * H + c + 3]);
    }
    for (int j = 0; j < width; ++j) {
      const float4 v =
          *(const float4*)(y + (long long)pos[t * width + j] * H + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[t * H + c] = __float2bfloat16(s.x);
    out[t * H + c + 1] = __float2bfloat16(s.y);
    out[t * H + c + 2] = __float2bfloat16(s.z);
    out[t * H + c + 3] = __float2bfloat16(s.w);
  }
}

__global__ void swiglu_kernel(const float* __restrict__ gu,
                              bf16* __restrict__ a, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float g = gu[2 * i], u = gu[2 * i + 1];
    a[i] = __float2bfloat16(g / (1.0f + expf(-g)) * u);
  }
}

}  // namespace iic

using iic::bf16;

extern "C" int iic_lm_gemm(int epi, int M, int N, int nz, const void* a,
                           long long lda, int k, const void* w,
                           long long ldw, const void* bias, const void* aux,
                           long long ldaux, void* c, long long ldc,
                           int c_f32, long long za, long long zw,
                           long long zc, void* stream) {
  iic::GemmArgs g = {};
  g.a[0] = a;
  g.w[0] = w;
  g.k[0] = k;
  g.wt[0] = 1;
  g.lda[0] = lda;
  g.ldw[0] = ldw;
  g.bias1 = bias;
  g.aux = aux;
  g.ldaux = ldaux;
  g.c = c;
  g.ldc = ldc;
  g.c_f32 = c_f32;
  g.M = M;
  g.N = N;
  g.epi = epi;
  g.za = za;
  g.zw = zw;
  g.zc = zc;
  g.aux2_div = 1;
  return iic::launch_gemm_tc<bf16>(g, nz, (cudaStream_t)stream);
}

extern "C" int iic_lm_rmsnorm(const void* x, const void* w, void* y,
                              int rows, int n, float eps, void* stream) {
  iic::rmsnorm_kernel<<<rows, iic::kNormThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)y, n, eps);
  return (int)cudaGetLastError();
}

extern "C" int iic_lm_latent_rope(void* q, long long ldq, const void* kva,
                                  const void* norm_w, const void* cos,
                                  const void* sin, long long ldcs, void* out,
                                  int rows, int nh, int dq, int dr, int r,
                                  float eps, void* stream) {
  if (dr > 64 || dr % 2) return (int)cudaErrorInvalidValue;
  iic::latent_rope_kernel<<<rows, iic::kNormThreads, 0,
                            (cudaStream_t)stream>>>(
      (bf16*)q, ldq, (const bf16*)kva, (const bf16*)norm_w,
      (const float*)cos, (const float*)sin, ldcs, (bf16*)out, nh, dq, dr, r,
      eps);
  return (int)cudaGetLastError();
}

extern "C" int iic_lm_mla_decode(const void* qlat, const void* q,
                                 long long ldq, const void* prefix, int Pc,
                                 int P, const void* slots, const void* table,
                                 long long ldt, const void* lens, int n_suf,
                                 void* out, int B, int K, int nh, int r,
                                 int dr, int dq, float scale, void* stream) {
  using namespace iic;
  if (nh != kMlaH || r != kMlaR || dr != kMlaDr || Pc % 16 || P > Pc ||
      Pc > 208 || K < 1 || n_suf > kMlaSuf || ldq % 8 || dq % 8)
    return (int)cudaErrorInvalidValue;
  MlaArgs a = {(const bf16*)qlat, (const bf16*)q, ldq, (const bf16*)prefix,
               Pc, P, (const bf16*)slots, (const int*)table, ldt,
               (const int*)lens, n_suf, (bf16*)out, B, K, dq, scale};
  const size_t smem = mla_smem(Pc);
  int err = allow_smem(mla_decode_kernel, smem);
  if (err != 0) return err;
  const dim3 grid(B, (K + kMlaLanes - 1) / kMlaLanes);
  mla_decode_kernel<<<grid, kMlaThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int iic_lm_router(const void* x, const void* w, const void* bias,
                             int N, int H, int E, int k, int norm,
                             float scale, void* ids, void* wts,
                             void* stream) {
  using namespace iic;
  if (E > kRtE || k > 32 || k > E || H % 32) return (int)cudaErrorInvalidValue;
  if (N >= 4096)
    router_kernel<16><<<(N + 15) / 16, 256, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)w, (const float*)bias, N, H, E, k,
        norm, scale, (int*)ids, (float*)wts);
  else
    router_kernel<8><<<(N + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)w, (const float*)bias, N, H, E, k,
        norm, scale, (int*)ids, (float*)wts);
  return (int)cudaGetLastError();
}

extern "C" int iic_lm_moe_dispatch(const void* ids, const void* w, int N,
                                   int k, int E, int G, int bm, int cap,
                                   void* counts, void* tile_group,
                                   void* tile_end, void* ntiles, void* pos,
                                   void* src, void* scale, void* stream) {
  using namespace iic;
  if (G > kDispMaxG || E > G) return (int)cudaErrorInvalidValue;
  dispatch_kernel<<<1, kDispThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)w, N, k, E, G, bm, cap, (int*)counts,
      (int*)tile_group, (int*)tile_end, (int*)ntiles, (int*)pos, (int*)src,
      (float*)scale);
  return (int)cudaGetLastError();
}

extern "C" int iic_lm_moe_gather(const void* x, const void* src,
                                 const void* ntiles, int cap, int H, void* a,
                                 void* stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  const long long n = (long long)cap * (H / 8);
  const int blocks = (int)std::min((n + 255) / 256, 16LL * iic::kSms);
  iic::gather_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int*)src, (const int*)ntiles, 128, H, (bf16*)a);
  return (int)cudaGetLastError();
}

extern "C" int iic_lm_grouped_gemm(int epi, const void* a, long long lda,
                                   int K, const void* w, int N, int G,
                                   const void* tile_group,
                                   const void* tile_end, const void* ntiles,
                                   int max_tiles, const void* scale, void* c,
                                   long long ldc, void* stream) {
  iic::GroupedArgs g = {a, w, c, ldc, (const float*)scale,
                        (const int*)tile_group, (const int*)tile_end,
                        (const int*)ntiles, K, N};
  return iic::launch_grouped(g, lda, max_tiles * iic::kPsBM, G, max_tiles,
                             epi, (cudaStream_t)stream);
}

extern "C" int iic_lm_moe_combine(const void* y, const void* pos, int N,
                                  int width, int H, const void* resid,
                                  void* out, void* stream) {
  if (H % 4) return (int)cudaErrorInvalidValue;
  iic::combine_kernel<<<N, 256, 0, (cudaStream_t)stream>>>(
      (const float*)y, (const int*)pos, width, H, (const bf16*)resid,
      (bf16*)out);
  return (int)cudaGetLastError();
}

extern "C" int iic_lm_swiglu(const void* gu, void* a, long long n,
                             void* stream) {
  const int blocks = (int)std::min((n + 255) / 256, 16LL * iic::kSms);
  iic::swiglu_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)gu, (bf16*)a, n);
  return (int)cudaGetLastError();
}

extern "C" int iic_lm_head_topk(const void* logits, int R, int V, int K,
                                void* topv, void* topi, void* lse,
                                void* stream) {
  return iic::launch_head(logits, R, V, K, topv, topi, lse, 1,
                          (cudaStream_t)stream);
}

// The library's counters: 0 the tensor-core GEMM's launches, 1 those on
// its persistent kernel; take resets the one read.
extern "C" int iic_lm_counter(int which, int take) {
  int* c[] = {&iic::tc_launches, &iic::tc_persistent_launches};
  if (which < 0 || which > 1) return -1;
  const int n = *c[which];
  if (take) *c[which] = 0;
  return n;
}
