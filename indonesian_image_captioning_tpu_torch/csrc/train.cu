// Kernels 8 and 9: the teacher-forcing scan of the caption trainer, forward
// and backward.
//
// Replaces indonesian_image_captioning_tpu/ops/train_pallas.py _fwd_call
// (body _make_fwd_kernel) and _bwd_call (body _make_bwd_kernel), the pair
// behind the custom VJP _train_scan, for both attention-bearing cells: SCN
// (attention_scn, gate order i, f, o, c) and the torch LSTM (pure_attention,
// gate order i, f, g, o).  The Pallas kernels keep each image chunk's
// encoder windows resident in VMEM across the whole scan; here the encoder
// state (B x 196 x 2,560 values: 64 MB at float32) is larger than all the
// card's shared memory, so each time step is a chain of launches, looped
// over T by the host functions at the bottom (one C call per scan), on one
// stream.
//
// Forward, per step t (h_prev = h0 or h_all[:, t-1]); "small" is the
// swap-AB tensor-core GEMM of mma_small.cuh on packed weights
// (ops/train_cuda.py pack_fwd):
//   small  hall = h_prev @ [wda | wfb] + [bda | bfb] (float32), and in
//          the same product SCN hfac = rt(rt(h_prev @ wh) semh), LSTM
//          hh = h_prev @ wh (float32)
//   attend one cluster of kCs CTAs per image (train_attend_kernel):
//          scores s[p] = sum_a rt(relu(rt(ea[p] + rt(hall_dec))) rt(wf)),
//          alpha = softmax_p(s) -> alphas[:, t] (float32),
//          awe_raw = rt(sum_p rt(alpha[p]) enc[p]) -> awe_raw[:, t],
//          gawe = rt(rt(sigmoid(hall_gate)) awe_raw)
//   SCN:   small xfac = rt(rt(emb_fac[:, t] + rt(gawe @ wxa)) semx)
//          small pre[g] = xfac[g] @ wxp[g] + hfac[g] @ whp[g] + bx + bh,
//                the cell in its epilogue -> h_all, c_all
//   LSTM:  small pre = rt(emb_fac[:, t] + rt(gawe @ wxa)) + hh + bx + bh,
//                the cell in its epilogue
//   cell   c = rt(rt(f c) + rt(i g)), h = rt(o rt(tanh c))
// Four launches a step for SCN, three for the LSTM.
//
// Backward: pass A recomputes, once for all T at M = B*T rows on the
// tensor-core GEMM of the decode chain (mma.cuh launch_gemm_tc), everything
// that depends only on the streamed inputs (h_prev, awe_raw, emb_fac):
// dec, the f_beta gate, awe, xin, xfac, hfac and the gate pre-activations
// (train_pallas.py:449-502).  The cell backward of the last step runs
// alone; then a reverse loop over t, per step:
//   SCN:    small (two products in one launch)
//           d_xfac = dpre[g] @ wxp[g]^T: d_emb = rt(d_xfac semx),
//                d_semx += d_xfac xin
//           d_hfac = dpre[g] @ whp[g]^T: dhfr = rt(d_hfac semh),
//                d_semh += d_hfac hfac_raw
//   small   d_awe = d_xin @ wxa^T: dfb = rt(d_awe awe_raw g (1 - g)),
//           d_awe_raw = rt(d_awe g)
//   attbwd  one cluster per image (train_att_bwd_kernel):
//           d_alpha[p] = sum_e d_awe_raw[e] enc[p, e] + d_alphas[:, t];
//           softmax backward; mask = rt(ea + dec) > 0;
//           d_ea += d_att mask (float32, in device memory);
//           d_dec_raw = sum_p rt(d_att) mask; wfdec += d_dec_raw dec;
//           ddec = rt(d_dec_raw wf)
//   small   dh = [dhfr | dfb | ddec] @ [wh ; wfb ; wda]^T (float32), and in
//           its epilogue the cell backward of step t - 1 -> dpre[:, t-1],
//           dc carried in float32 (at t = 0: dh0)
// Four launches a step for SCN, three for the LSTM; and a finalize: d_wf =
// sum_b (wfdec + sum_p rt(d_ea ea)), d_ea *= wf.  The weight gradients
// are (B*T)-row products over the streams, outside (ops/train_cuda.py), as
// the JAX package computes them outside its pallas_call.
//
// Determinism: no float atomics.  Every accumulation (d_ea, d_semx,
// d_semh, wfdec, dc) has one owner per launch and the launches run in
// order; split-K partials and the cluster's partial sums add in a fixed
// order; d_wf reduces over images in order.
//
// What bounds it: per step the encoder state streams from device memory
// (64 MB at float32 forward, and again backward with d_ea's 25.6 MB
// read-modify-write: about 1.0 and 1.4 ms over 51 steps at 3.35 TB/s),
// while the weights (8.65 M values, 35 MB at float32) are read again from
// L2 every step; the products' operations at 3xTF32 are a smaller bound.
// What the design does about it: every product runs on the tensor cores,
// the per-step ones shaped for 32 rows (swap-AB, mma_small.cuh) with the
// weights brought in by TMA under an L2 evict-last policy and the encoder
// state read with evict-first loads (ld.global.cs), so a step's traffic
// to device memory is the encoder stream; split-K sums inside a cluster
// without a reduce launch; the attention step is one cluster launch per
// image that exchanges the softmax statistics and the partial sums
// through distributed shared memory; the cell runs in the epilogue of the
// product that makes its pre-activations, its backward in the epilogue of
// the dh product.  What is left (PERF.md): each launch of the chain
// costs its own fixed 6-7 us on the card, 3-4 a step, each waiting on the
// one before; the attention kernels stream at about 2.2 TB/s.
#include <cooperative_groups.h>

#include "mma_small.cuh"

namespace cg = cooperative_groups;

namespace iic {

constexpr int kCs = 8;                 // CTAs of a cluster: one image
constexpr int kAttThreads = 256;
constexpr int kAttWarps = kAttThreads / 32;
constexpr int kMaxSlices = 8;          // pixel slices of the mask pass

// V elements of T at p (16-byte aligned for V = 8, 8- or 16-byte for V = 4)
// as float32, by an evict-first (streaming) load: the encoder state is read
// once a step and must not push the weights out of L2.
template <typename T, int V>
__device__ __forceinline__ void ld_stream(const T* p, float* x) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4)
      x[0] = __ldcs((const float*)p);
    else
      x[0] = __bfloat162float(
          __ushort_as_bfloat16(__ldcs((const unsigned short*)p)));
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "four float32 values a load");
    const float4 v = __ldcs((const float4*)p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    static_assert(V == 4 || V == 8, "four or eight bf16 values a load");
    uint32_t w[V / 2];
    if constexpr (V == 4) {
      const uint2 v = __ldcs((const uint2*)p);
      w[0] = v.x, w[1] = v.y;
    } else {
      const uint4 v = __ldcs((const uint4*)p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {   // a bf16's bits: a float's top half
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <int V>
__device__ __forceinline__ void st_stream(float* p, const float* x) {
  if constexpr (V == 1) {
    __stcs(p, x[0]);
  } else {
    static_assert(V == 4, "four float32 values a store");
    __stcs((float4*)p, make_float4(x[0], x[1], x[2], x[3]));
  }
}

// Vector widths of the attention kernels: the encoder rows (E) in 16-byte
// loads, the attention columns (A) four at a time, where both divide.
template <typename T, bool kVec>
struct AttV {
  static constexpr int E = kVec ? 16 / (int)sizeof(T) : 1;
  static constexpr int A = kVec ? 4 : 1;
};

template <typename T>
static bool att_vec(int E, int A) {
  return E % (16 / (int)sizeof(T)) == 0 && A % 4 == 0;
}

// ------------------------------------------------------------ forward ----

// The attention step of step t for image blockIdx.x / kCs: cluster rank r
// takes pixels [r pc, (r + 1) pc), scores them, and the cluster exchanges
// each CTA's max and sum of exponentials (the image's softmax) and its
// partial weighted sums (added in rank order) through distributed shared
// memory; rank r then finishes columns [r ec, (r + 1) ec) of awe_raw and
// the gated gawe.
template <typename T, bool kVec>
__global__ void __cluster_dims__(kCs, 1, 1) __launch_bounds__(kAttThreads)
    train_attend_kernel(const T* __restrict__ enc, const T* __restrict__ ea,
                        const float* __restrict__ hall, long long ldh,
                        const float* __restrict__ wf,
                        float* __restrict__ alphas, long long ldal,
                        T* __restrict__ awe_raw, long long ldawe,
                        T* __restrict__ gawe, int P, int E, int A) {
  constexpr int VE = AttV<T, kVec>::E, VA = AttV<T, kVec>::A;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / kCs;
  const int pc = (P + kCs - 1) / kCs;
  const int p0 = min(P, rank * pc), np = min(P, p0 + pc) - p0;
  extern __shared__ float smem[];
  float* dec_s = smem;        // A
  float* wf_s = dec_s + A;    // A
  float* part = wf_s + A;     // E: this CTA's weighted sums
  float* sc = part + E;       // pc: scores, then rt(alpha)
  __shared__ float stat[2];   // this CTA's max and sum of exp(s - max)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* hb = hall + b * ldh;
  for (int a = tid; a < A; a += kAttThreads) {
    dec_s[a] = rt<T>(hb[a]);
    wf_s[a] = rt<T>(wf[a]);
  }
  __syncthreads();
  for (int i = warp; i < np; i += kAttWarps) {       // a warp a pixel
    const T* row = ea + ((size_t)b * P + p0 + i) * A;
    float acc = 0.0f;
#pragma unroll 4
    for (int a = lane * VA; a < A; a += 32 * VA) {
      float x[VA];
      ld_stream<T, VA>(row + a, x);
#pragma unroll
      for (int u = 0; u < VA; ++u) {
        const float e = fmaxf(rt<T>(x[u] + dec_s[a + u]), 0.0f);
        acc += rt<T>(e * wf_s[a + u]);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) sc[i] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    float m = -INFINITY;
    for (int i = lane; i < np; i += 32) m = fmaxf(m, sc[i]);
    m = warp_max(m);
    float s = 0.0f;
    for (int i = lane; i < np; i += 32) s += expf(sc[i] - m);
    s = warp_sum(s);
    if (lane == 0) stat[0] = m, stat[1] = s;
  }
  cl.sync();
  float m = -INFINITY, ssum = 0.0f;
#pragma unroll
  for (int r = 0; r < kCs; ++r) m = fmaxf(m, cl.map_shared_rank(stat, r)[0]);
#pragma unroll
  for (int r = 0; r < kCs; ++r) {
    const float* st = cl.map_shared_rank(stat, r);
    if (st[1] > 0.0f) ssum += st[1] * expf(st[0] - m);
  }
  for (int i = tid; i < np; i += kAttThreads) {
    const float al = expf(sc[i] - m) / ssum;
    alphas[b * ldal + p0 + i] = al;
    sc[i] = rt<T>(al);
  }
  __syncthreads();
  const T* eb = enc + ((size_t)b * P + p0) * E;
  for (int q = tid * VE; q < E; q += kAttThreads * VE) {
    float acc[VE];
#pragma unroll
    for (int v = 0; v < VE; ++v) acc[v] = 0.0f;
    int i = 0;
    for (; i + 8 <= np; i += 8) {     // eight pixels' loads in flight
      float x[8][VE];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        ld_stream<T, VE>(eb + (size_t)(i + u) * E + q, x[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < VE; ++v) acc[v] += sc[i + u] * x[u][v];
    }
    for (; i < np; ++i) {
      float x[VE];
      ld_stream<T, VE>(eb + (size_t)i * E + q, x);
#pragma unroll
      for (int v = 0; v < VE; ++v) acc[v] += sc[i] * x[v];
    }
#pragma unroll
    for (int v = 0; v < VE; ++v) part[q + v] = acc[v];
  }
  cl.sync();
  const int ec = (E + kCs - 1) / kCs;
  const int e1 = min(E, (rank + 1) * ec);
  for (int e = rank * ec + tid; e < e1; e += kAttThreads) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kCs; ++r) s += cl.map_shared_rank(part, r)[e];
    const float ar = rt<T>(s);
    awe_raw[b * ldawe + e] = from_f<T>(ar);
    const float gate = rt<T>(sigmoidf_(hb[A + e]));
    gawe[(size_t)b * E + e] = from_f<T>(gate * ar);
  }
  cl.sync();   // no CTA leaves while another reads its shared memory
}

// ----------------------------------------------------------- backward ----

// The cell backward of the last step (dh = 0 on entry, so dh_t = d_hall):
// gate cotangents from the pass-A pre-activations and the dc carry.
template <typename T>
__global__ void train_cell_bwd_kernel(
    const float* __restrict__ pre, long long ldpre, const T* __restrict__ c_t,
    const T* __restrict__ c_prev, long long ldcp, const T* __restrict__ d_hall,
    long long ldc, const float* __restrict__ dh, float* __restrict__ dc,
    T* __restrict__ dpre, long long lddp, int B, int H, int lstm) {
  const int n = B * H;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    const int b = idx / H, j = idx % H;
    const float* p = pre + b * ldpre + j;
    const float pg[4] = {p[0], p[H], p[2 * H], p[3 * H]};
    float d[4];
    cell_bwd(pg, to_f(c_t[b * ldc + j]), to_f(c_prev[b * ldcp + j]),
             dh[idx] + to_f(d_hall[b * ldc + j]), dc[idx], d, lstm);
    T* out = dpre + b * lddp + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) out[g * H] = from_f<T>(d[g]);
  }
}

// The attention backward of step t for one image, a cluster of kCs CTAs
// (the forward's split of the pixels): d_alpha of this CTA's pixels, the
// image's softmax inner product summed over the cluster in rank order,
// d_att, then the relu-mask pass over ea: d_ea (each pixel's rows owned by
// one CTA) and this CTA's partial d_dec_raw, in pixel slices; rank r adds
// the partials (ranks, then slices, in order) for columns [r ac, (r + 1)
// ac): wfdec += d_dec_raw dec, ddec = rt(d_dec_raw wf).
template <typename T, bool kVec>
__global__ void __cluster_dims__(kCs, 1, 1) __launch_bounds__(kAttThreads)
    train_att_bwd_kernel(const T* __restrict__ enc, const T* __restrict__ ea,
                         const T* __restrict__ d_awe_raw,
                         const float* __restrict__ d_alphas, long long ldda,
                         const float* __restrict__ alphas, long long ldal,
                         const T* __restrict__ dec, long long lddec,
                         const float* __restrict__ wf,
                         float* __restrict__ d_ea, float* __restrict__ wfdec,
                         T* __restrict__ ddec, long long ldddec, int P, int E,
                         int A, int nsl) {
  constexpr int VE = AttV<T, kVec>::E, VA = AttV<T, kVec>::A;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / kCs;
  const int pc = (P + kCs - 1) / kCs;
  const int p0 = min(P, rank * pc), np = min(P, p0 + pc) - p0;
  extern __shared__ float smem[];
  float* g_s = smem;          // E: d_awe_raw
  float* part = g_s + E;      // nsl x A: partial d_dec_raw per slice
  float* dat = part + nsl * A;  // pc: d_alpha, then d_att
  float* datt = dat + pc;     // pc: rt(d_att)
  __shared__ float stat[1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < E; e += kAttThreads)
    g_s[e] = to_f(d_awe_raw[(size_t)b * E + e]);
  __syncthreads();
  for (int i = warp; i < np; i += kAttWarps) {       // a warp a pixel
    const T* row = enc + ((size_t)b * P + p0 + i) * E;
    float acc = 0.0f;
#pragma unroll 4
    for (int e = lane * VE; e < E; e += 32 * VE) {
      float x[VE];
      ld_stream<T, VE>(row + e, x);
#pragma unroll
      for (int v = 0; v < VE; ++v) acc += g_s[e + v] * x[v];
    }
    acc = warp_sum(acc);
    if (lane == 0) dat[i] = acc + d_alphas[b * ldda + p0 + i];
  }
  __syncthreads();
  const float* al = alphas + b * ldal + p0;
  if (warp == 0) {
    float inner = 0.0f;
    for (int i = lane; i < np; i += 32) inner += dat[i] * al[i];
    inner = warp_sum(inner);
    if (lane == 0) stat[0] = inner;
  }
  cl.sync();
  float inner = 0.0f;
#pragma unroll
  for (int r = 0; r < kCs; ++r) inner += cl.map_shared_rank(stat, r)[0];
  for (int i = tid; i < np; i += kAttThreads) {
    const float v = al[i] * (dat[i] - inner);
    dat[i] = v;
    datt[i] = rt<T>(v);
  }
  __syncthreads();
  const int nq = (A + VA - 1) / VA;
  const T* dec_b = dec + b * lddec;
  for (int w = tid; w < nq * nsl; w += kAttThreads) {
    const int a = (w % nq) * VA, sl = w / nq;
    float dv[VA], acc[VA];
#pragma unroll
    for (int v = 0; v < VA; ++v) {
      dv[v] = to_f(dec_b[a + v]);
      acc[v] = 0.0f;
    }
#pragma unroll 4
    for (int i = sl; i < np; i += nsl) {
      const size_t at = ((size_t)b * P + p0 + i) * A + a;
      float x[VA], d[VA];
      ld_stream<T, VA>(ea + at, x);
      ld_stream<float, VA>(d_ea + at, d);
#pragma unroll
      for (int v = 0; v < VA; ++v) {
        if (rt<T>(x[v] + dv[v]) > 0.0f) {
          d[v] += dat[i];
          acc[v] += datt[i];
        }
      }
      st_stream<VA>(d_ea + at, d);
    }
#pragma unroll
    for (int v = 0; v < VA; ++v) part[sl * A + a + v] = acc[v];
  }
  cl.sync();
  const int ac = (A + kCs - 1) / kCs;
  const int a1 = min(A, (rank + 1) * ac);
  for (int a = rank * ac + tid; a < a1; a += kAttThreads) {
    float s = 0.0f;
    for (int r = 0; r < kCs; ++r) {
      const float* pr = cl.map_shared_rank(part, r);
      for (int sl = 0; sl < nsl; ++sl) s += pr[sl * A + a];
    }
    wfdec[(size_t)b * A + a] += s * to_f(dec_b[a]);
    ddec[b * ldddec + a] = from_f<T>(s * wf[a]);
  }
  cl.sync();
}

constexpr int kColThreads = 128;

// part[b, a] = wfdec[b, a] + sum_p rt(d_ea ea); d_ea *= wf.
// Grid (ceil(A / 128), B).
template <typename T>
__global__ void __launch_bounds__(kColThreads)
train_wf_part_kernel(float* __restrict__ d_ea, const T* __restrict__ ea,
                     const float* __restrict__ wf,
                     const float* __restrict__ wfdec,
                     float* __restrict__ part, int P, int A) {
  const int b = blockIdx.y;
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  const float w = wf[a];
  float s = 0.0f;
  for (int p = 0; p < P; ++p) {
    const size_t i = ((size_t)b * P + p) * A + a;
    const float x = d_ea[i];
    s += rt<T>(x * to_f(ea[i]));
    d_ea[i] = x * w;
  }
  part[(size_t)b * A + a] = wfdec[(size_t)b * A + a] + s;
}

// d_wf[a] = sum_b part[b, a], images in order.
__global__ void train_wf_sum_kernel(const float* __restrict__ part,
                                    float* __restrict__ d_wf, int B, int A) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += part[(size_t)b * A + a];
  d_wf[a] = s;
}

// ---------------------------------------------------------- host loop ----

// Everything one scan needs, forward or backward (unused pointers null).
// Every field is 8 bytes; ops/train_cuda.py mirrors it field for field and
// checks its size against iic_train_args_bytes().  Shapes: enc (B, P, E),
// ea (B, P, A), emb_fac (B, T, F4), semx/semh (B, F4), h0/c0 (B, D); (B, T,
// .) tensors are contiguous, time-major within an image.  The packed
// weights are ops/train_cuda.py's (rows, ld) K-major forms.
struct TrainArgs {
  long long B, T, P, E, A, D, F4, lstm, split_cap;
  long long ldw1, ldwxa, ldwg, fp, ldwxan;
  const void *enc, *ea, *emb_fac, *semx, *semh, *h0, *c0;
  // the weights as the JAX package lays them out (the backward's products
  // read wda, wfb, wxa, wh, wxp, whp in place), biases and wf
  const void *wda, *bda, *wf, *wfb, *bfb, *wxa, *wh, *wxp, *whp, *bx, *bh;
  const void* bxh;  // bx + bh, float32 (the forward's cell)
  // forward packs: w1 = [wda | wfb | wh]^T, wxa^T (SCN: as is; LSTM: gate
  // interleaved), SCN gates [wxp_g | whp_g]^T interleaved (halves fp apart)
  const void *w1, *wxa_p, *wg;
  // pass A's packs (mma.cuh, hi and lo at float32): w1, wxa^T as is, and
  // wxp^T, whp^T per gate (step_cuda.pack_tc)
  const void *w1_hi, *w1_lo, *wxan_hi, *wxan_lo, *wxp_hi, *wxp_lo, *whp_hi,
      *whp_lo;
  void *h_all, *c_all, *alphas, *awe_raw;  // forward out, backward in
  const void *h_prev, *d_hall, *d_alphas;  // backward in; h_prev (B*T, D)
  void *d_ea, *d_emb, *d_semx, *d_semh, *dh, *dc, *d_wf;  // backward out
  void *awe, *xfac, *hfac, *dpre, *dhfr, *dfb, *ddec;     // streams (B*T, .)
  // forward scratch: hall (B, A+E) f32, hh (B, 4D) f32 (LSTM), gawe (B,
  // E), xfac/hfac (B, F4)
  void *s_hall, *s_hh, *s_gawe, *s_xfac, *s_hfac;
  // backward scratch: dec (B*T, A), gate (B*T, E) f32, xin (B*T, F4),
  // hfac_raw (B*T, F4) f32, pre (B*T, 4D) f32, d_awe_raw (B, E),
  // wfdec (B, A) f32, part (B, A) f32
  void *s_dec, *s_gate, *s_xin_all, *s_hfac_raw, *s_pre_all, *s_d_awe_raw,
      *s_wfdec, *s_part;
  void* s_split;    // pass A's split-K partials, split_cap floats
};

// Launches of the last forward call, of the last backward's reverse loop
// and of the rest of that backward (ops/train_cuda.py last_launches).
static long long g_launches[3] = {0, 0, 0};

#define IIC_TRY(x)              \
  do {                          \
    const int err_ = (x);       \
    if (err_ != 0) return err_; \
  } while (0)

static inline GemmArgs gemm_args(const TrainArgs& r, int M, int N, int epi) {
  GemmArgs g = {};
  g.M = M;
  g.N = N;
  g.epi = epi;
  g.part = (float*)r.s_split;
  g.part_cap = r.split_cap;
  return g;
}

// Source s of a pass-A product: A (M, lda) times the packed W (N, K)
// rows from `row` on, hi and lo parts.
template <typename T>
static void src_tc(GemmArgs& g, int s, const void* a, long long lda,
                   const void* hi, const void* lo, long long ldw,
                   long long row, int k) {
  g.a[s] = a;
  g.lda[s] = lda;
  g.w[s] = (const T*)hi + row * ldw;
  g.w_lo[s] = lo ? (const void*)((const T*)lo + row * ldw) : nullptr;
  g.ldw[s] = ldw;
  g.k[s] = k;
  g.wt[s] = 1;
}

template <typename T>
static int small(const TrainArgs& r, const SmallProb& p0,
                 const SmallProb* p1, cudaStream_t s, int slot) {
  SmallLaunch L = {};
  L.p[0] = p0;
  L.nprob = 1;
  if (p1 != nullptr) L.p[L.nprob++] = *p1;
  L.B = (int)r.B;
  ++g_launches[slot];
  return launch_small_epi<T>(L, s);
}

template <typename T, bool kVec>
static int launch_attend(const TrainArgs& r, int t, cudaStream_t s) {
  const int P = r.P, E = r.E, A = r.A;
  const int pc = (P + kCs - 1) / kCs;
  const size_t smem = sizeof(float) * (2 * A + E + pc);
  IIC_TRY(allow_smem(train_attend_kernel<T, kVec>, smem));
  train_attend_kernel<T, kVec><<<(int)r.B * kCs, kAttThreads, smem, s>>>(
      (const T*)r.enc, (const T*)r.ea, (const float*)r.s_hall, A + E,
      (const float*)r.wf, (float*)r.alphas + (long long)t * P,
      (long long)r.T * P, (T*)r.awe_raw + (long long)t * E,
      (long long)r.T * E, (T*)r.s_gawe, P, E, A);
  ++g_launches[0];
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
static int launch_att_bwd(const TrainArgs& r, int t, cudaStream_t s) {
  const int P = r.P, E = r.E, A = r.A;
  const int pc = (P + kCs - 1) / kCs;
  const int nq = (A + AttV<T, kVec>::A - 1) / AttV<T, kVec>::A;
  const int nsl = std::max(1, std::min(kMaxSlices, kAttThreads / nq));
  const size_t smem = sizeof(float) * (E + nsl * A + 2 * pc);
  IIC_TRY(allow_smem(train_att_bwd_kernel<T, kVec>, smem));
  const long long TP = r.T * P, TA = r.T * A;
  train_att_bwd_kernel<T, kVec><<<(int)r.B * kCs, kAttThreads, smem, s>>>(
      (const T*)r.enc, (const T*)r.ea, (const T*)r.s_d_awe_raw,
      (const float*)r.d_alphas + (long long)t * P, TP,
      (const float*)r.alphas + (long long)t * P, TP,
      (const T*)r.s_dec + (long long)t * A, TA, (const float*)r.wf,
      (float*)r.d_ea, (float*)r.s_wfdec, (T*)r.ddec + (long long)t * A, TA,
      P, E, A, nsl);
  ++g_launches[1];
  return (int)cudaGetLastError();
}

template <typename T>
static int train_fwd(const TrainArgs& r, cudaStream_t s) {
  const int T_ = r.T, E = r.E, A = r.A, D = r.D;
  const int F4 = r.F4, H = D, F = F4 / 4;
  const int lstm = (int)r.lstm;
  const int Nh = lstm ? 4 * H : F4;    // the h @ wh columns of w1
  const int Hp = (H + kSmM - 1) / kSmM * kSmM;   // a gate pack's units
  const bool vec = att_vec<T>(E, A);
  g_launches[0] = 0;
  for (int t = 0; t < T_; ++t) {
    const T* hp = t == 0 ? (const T*)r.h0 : (const T*)r.h_all + (t - 1) * D;
    const T* cp = t == 0 ? (const T*)r.c0 : (const T*)r.c_all + (t - 1) * D;
    const long long ldh = t == 0 ? D : (long long)T_ * D;
    T* h_out = (T*)r.h_all + (long long)t * D;
    T* c_out = (T*)r.c_all + (long long)t * D;
    // hall | hfac (SCN) or hh (LSTM)
    SmallProb p = small_prob(A + E + Nh, kSmHall);
    small_src(p, hp, ldh, r.w1, r.ldw1, A + E + Nh, D);
    p.n1 = A, p.n2 = A + E, p.lstm = lstm;
    p.bias1 = r.bda, p.bias2 = r.bfb;
    p.out = r.s_hall, p.ldo = A + E;
    if (lstm) {
      p.out2 = r.s_hh, p.ldo2 = 4 * H;
    } else {
      p.aux = r.semh, p.ldaux = F4;
      p.out2 = r.s_hfac, p.ldo2 = F4;
    }
    IIC_TRY(small<T>(r, p, nullptr, s, 0));
    IIC_TRY((vec ? launch_attend<T, true>(r, t, s)
                 : launch_attend<T, false>(r, t, s)));
    const T* emb_t = (const T*)r.emb_fac + (long long)t * F4;
    if (lstm) {   // gawe @ wxa, the cell in the epilogue
      p = small_prob(H, kSmCell);
      gates_interleaved(p);
      small_src(p, r.s_gawe, E, r.wxa_p, r.ldwxa, 4 * Hp, E);
      p.lstm = 1;
      p.aux = emb_t, p.ldaux = (long long)T_ * F4;
      p.aux2 = r.s_hh, p.ldaux2 = 4 * H;
    } else {      // xfac, then the gates with the cell in the epilogue
      p = small_prob(F4, kSmXfac);
      small_src(p, r.s_gawe, E, r.wxa_p, r.ldwxa, F4, E);
      p.aux = emb_t, p.ldaux = (long long)T_ * F4;
      p.aux2 = r.semx, p.ldaux2 = F4;
      p.out = r.s_xfac, p.ldo = F4;
      IIC_TRY(small<T>(r, p, nullptr, s, 0));
      p = small_prob(H, kSmCell);
      gates_interleaved(p);
      p.zx = F;
      small_src(p, r.s_xfac, F4, r.wg, r.ldwg, 4 * Hp, F);
      small_src(p, r.s_hfac, F4, (const T*)r.wg + r.fp, r.ldwg, 4 * Hp, F);
    }
    p.bias1 = r.bxh;
    p.aux3 = cp, p.ldaux3 = ldh;
    p.out = h_out, p.ldo = (long long)T_ * D;
    p.out2 = c_out, p.ldo2 = (long long)T_ * D;
    IIC_TRY(small<T>(r, p, nullptr, s, 0));
  }
  return 0;
}

template <typename T>
static int train_bwd(const TrainArgs& r, cudaStream_t s) {
  const int B = r.B, T_ = r.T, E = r.E, A = r.A, D = r.D;
  const int F4 = r.F4, H = D, F = F4 / 4, M = B * T_;
  const int lstm = (int)r.lstm;
  const int N4 = lstm ? 4 * H : F4;    // wxa's and wh's output width
  const long long TD = (long long)T_ * D, T4 = (long long)T_ * 4 * H;
  const bool vec = att_vec<T>(E, A);
  g_launches[1] = g_launches[2] = 0;
  const int tc0 = tc_launches;

  // ---- pass A: the recompute, at M = B*T rows ----
  GemmArgs g = gemm_args(r, M, A, kEpiBias);
  src_tc<T>(g, 0, r.h_prev, D, r.w1_hi, r.w1_lo, r.ldw1, 0, D);
  g.bias1 = r.bda;
  g.c = r.s_dec, g.ldc = A;
  IIC_TRY(launch_gemm_tc<T>(g, 1, s));
  g = gemm_args(r, M, E, kEpiGate);
  src_tc<T>(g, 0, r.h_prev, D, r.w1_hi, r.w1_lo, r.ldw1, A, D);
  g.bias1 = r.bfb;
  g.aux = r.awe_raw, g.ldaux = E;
  g.c = r.s_gate, g.ldc = E, g.c_f32 = 1;
  g.c2 = r.awe, g.ldc2 = E;
  IIC_TRY(launch_gemm_tc<T>(g, 1, s));
  g = gemm_args(r, M, N4, kEpiAddMul);
  src_tc<T>(g, 0, r.awe, E, r.wxan_hi, r.wxan_lo, r.ldwxan, 0, E);
  g.aux = r.emb_fac, g.ldaux = N4;
  g.c = r.s_xin_all, g.ldc = N4;
  if (!lstm) {
    g.aux2 = r.semx, g.ldaux2 = F4, g.aux2_div = T_;
    g.c2 = r.xfac, g.ldc2 = F4;
  }
  IIC_TRY(launch_gemm_tc<T>(g, 1, s));
  if (!lstm) {
    g = gemm_args(r, M, F4, kEpiRawMul);
    src_tc<T>(g, 0, r.h_prev, D, r.w1_hi, r.w1_lo, r.ldw1, A + E, D);
    g.aux2 = r.semh, g.ldaux2 = F4, g.aux2_div = T_;
    g.c = r.s_hfac_raw, g.ldc = F4, g.c_f32 = 1;
    g.c2 = r.hfac, g.ldc2 = F4;
    IIC_TRY(launch_gemm_tc<T>(g, 1, s));
    g = gemm_args(r, M, H, kEpiPre);   // the four gates as z
    src_tc<T>(g, 0, r.xfac, F4, r.wxp_hi, r.wxp_lo, F, 0, F);
    src_tc<T>(g, 1, r.hfac, F4, r.whp_hi, r.whp_lo, F, 0, F);
    g.bias1 = r.bx, g.bias2 = r.bh;
    g.c = r.s_pre_all, g.ldc = 4 * H, g.c_f32 = 1;
    g.za = F, g.zw = (long long)H * F, g.zc = H, g.zb = H;
    IIC_TRY(launch_gemm_tc<T>(g, 4, s));
  } else {
    g = gemm_args(r, M, 4 * H, kEpiPre);
    src_tc<T>(g, 0, r.h_prev, D, r.w1_hi, r.w1_lo, r.ldw1, A + E, D);
    g.bias1 = r.bx, g.bias2 = r.bh;
    g.aux = r.s_xin_all, g.ldaux = 4 * H;
    g.c = r.s_pre_all, g.ldc = 4 * H, g.c_f32 = 1;
    IIC_TRY(launch_gemm_tc<T>(g, 1, s));
  }
  g_launches[2] += tc_launches - tc0;

  // ---- the cell backward of the last step (dh = 0) ----
  {
    const int t = T_ - 1;
    const void* cp = t == 0 ? r.c0 : (const T*)r.c_all + (t - 1) * D;
    train_cell_bwd_kernel<T><<<(B * H + 255) / 256, 256, 0, s>>>(
        (const float*)r.s_pre_all + (long long)t * 4 * H, T4,
        (const T*)r.c_all + (long long)t * D, (const T*)cp, t == 0 ? D : TD,
        (const T*)r.d_hall + (long long)t * D, TD, (const float*)r.dh,
        (float*)r.dc, (T*)r.dpre + (long long)t * 4 * H, T4, B, H, lstm);
    ++g_launches[2];
    IIC_TRY((int)cudaGetLastError());
  }

  // ---- the reverse scan ----
  for (int t = T_ - 1; t >= 0; --t) {
    const T* dpre_t = (const T*)r.dpre + (long long)t * 4 * H;
    const void* dxin = dpre_t;
    long long lddx = T4;
    if (!lstm) {   // the two factor products, one launch
      const long long ldf = (long long)T_ * F4;
      SmallProb px = small_prob(F, kSmFac);
      px.nz = 4, px.z_rows = F, px.zx = H;
      small_src(px, dpre_t, T4, r.wxp, H, F4, H);
      SmallProb ph = px;
      px.aux = r.semx, px.ldaux = F4;
      px.aux2 = (const T*)r.s_xin_all + (long long)t * F4, px.ldaux2 = ldf;
      px.acc = (float*)r.d_semx, px.ldacc = F4;
      px.out = (T*)r.d_emb + (long long)t * F4, px.ldo = ldf;
      ph.w[0] = r.whp;
      ph.aux = r.semh, ph.ldaux = F4;
      ph.aux2 = (const float*)r.s_hfac_raw + (long long)t * F4;
      ph.ldaux2 = ldf, ph.aux2_f32 = 1;
      ph.acc = (float*)r.d_semh, ph.ldacc = F4;
      ph.out = (T*)r.dhfr + (long long)t * F4, ph.ldo = ldf;
      IIC_TRY(small<T>(r, px, &ph, s, 1));
      dxin = (const T*)r.d_emb + (long long)t * F4;
      lddx = ldf;
    }
    // d_awe = d_xin @ wxa^T -> dfb, d_awe_raw
    const long long TE = (long long)T_ * E;
    SmallProb p = small_prob(E, kSmGateBwd);
    small_src(p, dxin, lddx, r.wxa, N4, E, N4);
    p.aux = (const T*)r.awe_raw + (long long)t * E, p.ldaux = TE;
    p.aux2 = (const float*)r.s_gate + (long long)t * E, p.ldaux2 = TE;
    p.out = (T*)r.dfb + (long long)t * E, p.ldo = TE;
    p.out2 = r.s_d_awe_raw, p.ldo2 = E;
    IIC_TRY(small<T>(r, p, nullptr, s, 1));
    IIC_TRY((vec ? launch_att_bwd<T, true>(r, t, s)
                 : launch_att_bwd<T, false>(r, t, s)));
    // dh = [dhfr | dfb | ddec] @ [wh ; wfb ; wda]^T (LSTM: dpre for dhfr),
    // then the cell backward of step t - 1
    p = small_prob(D, kSmDh);
    if (!lstm)
      small_src(p, (const T*)r.dhfr + (long long)t * F4, (long long)T_ * F4,
                r.wh, F4, D, F4);
    else
      small_src(p, dpre_t, T4, r.wh, 4 * H, D, 4 * H);
    small_src(p, (const T*)r.dfb + (long long)t * E, TE, r.wfb, E, D, E);
    small_src(p, (const T*)r.ddec + (long long)t * A, (long long)T_ * A,
              r.wda, A, D, A);
    if (t == 0) {
      p.out = r.dh, p.ldo = D;
    } else {
      p.n1 = 1, p.lstm = lstm;
      p.aux2 = (const float*)r.s_pre_all + (long long)(t - 1) * 4 * H;
      p.ldaux2 = T4;
      p.aux = (const T*)r.c_all + (long long)(t - 1) * D, p.ldaux = TD;
      p.aux3 = t == 1 ? r.c0 : (const T*)r.c_all + (long long)(t - 2) * D;
      p.ldaux3 = t == 1 ? D : TD;
      p.aux4 = (const T*)r.d_hall + (long long)(t - 1) * D, p.ldaux4 = TD;
      p.acc = (float*)r.dc, p.ldacc = D;
      p.out2 = (T*)r.dpre + (long long)(t - 1) * 4 * H, p.ldo2 = T4;
    }
    IIC_TRY(small<T>(r, p, nullptr, s, 1));
  }

  // ---- finalize: the wf gradient and d_ea *= wf ----
  const dim3 grid_a((A + kColThreads - 1) / kColThreads, B);
  train_wf_part_kernel<T><<<grid_a, kColThreads, 0, s>>>(
      (float*)r.d_ea, (const T*)r.ea, (const float*)r.wf,
      (const float*)r.s_wfdec, (float*)r.s_part, r.P, A);
  IIC_TRY((int)cudaGetLastError());
  train_wf_sum_kernel<<<(A + kColThreads - 1) / kColThreads, kColThreads, 0,
                        s>>>((const float*)r.s_part, (float*)r.d_wf, B, A);
  g_launches[2] += 2;
  return (int)cudaGetLastError();
}

}  // namespace iic

extern "C" int iic_train_args_bytes() { return (int)sizeof(iic::TrainArgs); }

// Launches of the last call: 0 the forward's, 1 the backward's reverse
// loop, 2 the rest of the backward (pass A's products and the cell and
// finalize kernels).
extern "C" int iic_train_launches(int which) {
  return which >= 0 && which < 3 ? (int)iic::g_launches[which] : -1;
}

// The persistent kernel's launches (csrc/mma.cuh: pass A's products) by
// this library since the last call (ops/train_cuda.py adds them to
// step_cuda.gemm.persistent_launches).
extern "C" int iic_tc_persistent_launches_take() {
  const int n = iic::tc_persistent_launches;
  iic::tc_persistent_launches = 0;
  return n;
}

// The per-step GEMM alone, for the card tests: out (B, N) float32 = x (B,
// K) @ w (N, K)^T, w K-major.
extern "C" int iic_small_gemm(int dtype, const void* x, long long ldx,
                              const void* w, long long ldw, int B, int N,
                              int K, void* out, void* stream) {
  iic::SmallLaunch L = {};
  L.nprob = 1;
  L.B = B;
  iic::SmallProb& p = L.p[0];
  p = iic::small_prob(N, iic::kSmPlain);
  iic::small_src(p, x, ldx, w, ldw, N, K);
  p.out = out;
  p.ldo = N;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::launch_small<float, iic::kSmPlain>(L, s);
  if (dtype == iic::kBF16)
    return iic::launch_small<__nv_bfloat16, iic::kSmPlain>(L, s);
  return (int)cudaErrorInvalidValue;
}

// Run the whole forward scan (every step's launches) on the stream.
// Returns the first failing launch's CUDA error code, 0 on success.
extern "C" int iic_train_fwd(int dtype, const void* args, void* stream) {
  const iic::TrainArgs& r = *(const iic::TrainArgs*)args;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32) return iic::train_fwd<float>(r, s);
  if (dtype == iic::kBF16) return iic::train_fwd<__nv_bfloat16>(r, s);
  return (int)cudaErrorInvalidValue;
}

// Pass A, the reverse scan and the finalize.  d_ea, d_semx, d_semh, dh,
// dc and the scratch wfdec must be zero on entry.
extern "C" int iic_train_bwd(int dtype, const void* args, void* stream) {
  const iic::TrainArgs& r = *(const iic::TrainArgs*)args;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32) return iic::train_bwd<float>(r, s);
  if (dtype == iic::kBF16) return iic::train_bwd<__nv_bfloat16>(r, s);
  return (int)cudaErrorInvalidValue;
}
