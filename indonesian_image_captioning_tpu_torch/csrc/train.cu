// Kernels 8 and 9: the teacher-forcing scan of the caption trainer, forward
// and backward.
//
// Replaces indonesian_image_captioning_tpu/ops/train_pallas.py _fwd_call
// (body _make_fwd_kernel) and _bwd_call (body _make_bwd_kernel), the pair
// behind the custom VJP _train_scan, for both attention-bearing cells: SCN
// (attention_scn, gate order i, f, o, c) and the torch LSTM (pure_attention,
// gate order i, f, g, o).  The Pallas kernels keep each image chunk's
// encoder windows resident in VMEM across the whole scan; an image's
// encoder state (1.06 MB at bf16) does not fit an SM's shared memory, so
// here each time step is a chain of launches, looped over T by the host
// functions at the bottom (one C call per scan), on one stream.
//
// Forward, per step t (h_prev = h0 or h_all[:, t-1]):
//   gemm   hall  = h_prev @ [wda | wfb] + [bda | bfb]           (float32)
//   scores s[p]  = sum_a rt(relu(rt(ea[p] + rt(hall_dec))) * rt(wf))
//   sum    alpha = softmax_p(s) -> alphas[:, t] (float32)
//          awe_raw = sum_p rt(alpha[p]) enc[p] -> awe_raw[:, t]
//          gawe = rt(rt(sigmoid(hall_gate)) * awe_raw)
//   gemm   xin = rt(emb_fac[:, t] + rt(gawe @ wxa)); SCN xfac = rt(xin semx)
//   SCN:   gemm hfac = rt(rt(h_prev @ wh) * semh)
//          gemm pre[g] = xfac[g] @ wxp[g] + hfac[g] @ whp[g] + bx[g] + bh[g]
//   LSTM:  gemm pre = xin + h_prev @ wh + bx + bh
//   cell   c = rt(rt(f c) + rt(i g)), h = rt(o rt(tanh c)) -> h_all, c_all
//
// Backward: pass A recomputes, once for all T at M = B*T rows, everything
// that depends only on the streamed inputs (h_prev, awe_raw, emb_fac):
// dec, the f_beta gate, awe, xin, xfac, hfac and the gate pre-activations
// (train_pallas.py:449-502).  Then a reverse loop over t, per step:
//   cell    the cell backward -> dpre[:, t]; dc carried in float32
//   SCN:    gemm d_xfac = dpre[g] @ wxp[g]^T: d_emb = rt(d_xfac semx),
//                d_semx += d_xfac xin
//           gemm d_hfac = dpre[g] @ whp[g]^T: dhfr = rt(d_hfac semh),
//                d_semh += d_hfac hfac_raw
//   gemm    d_awe = d_xin @ wxa^T: dfb = rt(d_awe awe_raw g (1 - g)),
//           d_awe_raw = rt(d_awe g)
//   dalpha  d_alpha[p] = sum_e d_awe_raw[e] enc[p, e] + d_alphas[:, t]
//   attbwd  softmax backward; mask = rt(ea + dec) > 0;
//           d_ea += d_att mask (float32, in device memory);
//           d_dec_raw = sum_p rt(d_att) mask; wfdec += d_dec_raw dec;
//           ddec = rt(d_dec_raw wf)
//   gemm    dh = [dhfr | dfb | ddec] @ [wh ; wfb ; wda]^T   (float32)
// and a finalize: d_wf = sum_b (wfdec + sum_p rt(d_ea ea)), d_ea *= wf.
// The weight gradients are (B*T)-row products over the streams, outside
// (ops/train_cuda.py), as the JAX package computes them outside its
// pallas_call.  Every product of the two Pallas bodies runs in gemm_kernel
// (gemm.cuh) or in the kernels below.
//
// Determinism: no atomics.  Every accumulation (d_ea, d_semx, d_semh,
// wfdec, dc) is owned by one thread per launch and the launches run in
// order; d_wf reduces over images in a fixed order.
//
// What bounds it: at B = 32 the per-step products have 32 rows, so each
// reads its weight (up to 2048 x 2048) for little arithmetic, and the
// attention steps read the encoder state (2 MB per image at float32) once
// forward and once backward per step.  The scan is a chain of about 7
// launches per step (forward) and 7 (backward), 51 steps each.  What the
// design does about it, in this first version: the 32-row products run
// split-K (gemm.cuh) so they fill the card instead of 8-40 blocks, the
// encoder state is read once per step for all of an image's pixels and
// columns, every elementwise stage is fused into a GEMM epilogue or the
// attention kernels, and pass A moves the recompute half of the backward
// into large (B*T)-row GEMMs.  Tensor cores and CUDA graphs over the step
// chain are later work.
#include "gemm.cuh"

namespace iic {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ------------------------------------------------------------ forward ----

// Scores of one step: one warp per pixel.  Grid (B, ceil(P / 8)).  dec is
// the first A columns of hall (float32, bias added), rounded to T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
train_scores_kernel(const T* __restrict__ ea, const float* __restrict__ hall,
                    long long ldhall, const float* __restrict__ wf,
                    float* __restrict__ scores, int P, int A) {
  extern __shared__ float smem[];
  float* dec_s = smem;     // A
  float* wf_s = smem + A;  // A
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = blockIdx.y * kWarps + (tid >> 5);
  for (int a = tid; a < A; a += blockDim.x) {
    dec_s[a] = rt<T>(hall[b * ldhall + a]);
    wf_s[a] = rt<T>(wf[a]);
  }
  __syncthreads();
  if (p >= P) return;
  const T* row = ea + ((size_t)b * P + p) * A;
  float acc = 0.0f;
#pragma unroll 4
  for (int a = lane; a < A; a += 32) {
    const float e = fmaxf(rt<T>(to_f(row[a]) + dec_s[a]), 0.0f);
    acc += rt<T>(e * wf_s[a]);
  }
  acc = warp_sum(acc);
  if (lane == 0) scores[(size_t)b * P + p] = acc;
}

// Softmax, the weighted sum over this block's columns and the f_beta gate.
// Grid (B, esplit); block y == 0 writes alpha.
template <typename T>
__global__ void __launch_bounds__(kThreads)
train_attend_kernel(const T* __restrict__ enc,
                    const float* __restrict__ scores,
                    const float* __restrict__ hall, long long ldhall, int A,
                    float* __restrict__ alphas, long long ldal,
                    T* __restrict__ awe_raw, long long ldawe,
                    T* __restrict__ gawe, int P, int E, int e_chunk) {
  extern __shared__ float smem[];
  float* att = smem;       // P: scores, then alpha
  float* att_t = smem + P; // P: alpha rounded to T
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int p = tid; p < P; p += blockDim.x) att[p] = scores[(size_t)b * P + p];
  __syncthreads();
  if (tid < 32) {
    float m = -INFINITY;
    for (int p = tid; p < P; p += 32) m = fmaxf(m, att[p]);
    m = warp_max(m);
    float s = 0.0f;
    for (int p = tid; p < P; p += 32) s += expf(att[p] - m);
    s = warp_sum(s);
    for (int p = tid; p < P; p += 32) {
      const float v = expf(att[p] - m) / s;
      att[p] = v;
      att_t[p] = rt<T>(v);
      if (blockIdx.y == 0) alphas[b * ldal + p] = v;
    }
  }
  __syncthreads();
  const T* enc_b = enc + (size_t)b * P * E;
  const int e0 = blockIdx.y * e_chunk;
  const int e1 = min(E, e0 + e_chunk);
  for (int e = e0 + tid; e < e1; e += blockDim.x) {
    float acc = 0.0f;
    int p = 0;
    for (; p + 8 <= P; p += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = to_f(enc_b[(size_t)(p + j) * E + e]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += att_t[p + j] * x[j];
    }
    for (; p < P; ++p) acc += att_t[p] * to_f(enc_b[(size_t)p * E + e]);
    const float ar = rt<T>(acc);
    awe_raw[b * ldawe + e] = from_f<T>(ar);
    const float gate = rt<T>(sigmoidf_(hall[b * ldhall + A + e]));
    gawe[(size_t)b * E + e] = from_f<T>(gate * ar);
  }
}

// The cell on float32 pre-activations (not rounded first, as the Pallas
// forward): SCN gates i, f, o, c; LSTM i, f, g, o.
template <typename T>
__global__ void train_cell_kernel(const float* __restrict__ pre,
                                  const T* __restrict__ c_prev,
                                  long long ldcp, T* __restrict__ h_out,
                                  T* __restrict__ c_out, long long ldo, int B,
                                  int H, int lstm) {
  const int n = B * H;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    const int b = idx / H, j = idx % H;
    const float* p = pre + (size_t)b * 4 * H;
    const float ig = rt<T>(sigmoidf_(p[j]));
    const float fg = rt<T>(sigmoidf_(p[H + j]));
    float og, gg;
    if (lstm) {
      gg = rt<T>(tanhf(p[2 * H + j]));
      og = rt<T>(sigmoidf_(p[3 * H + j]));
    } else {
      og = rt<T>(sigmoidf_(p[2 * H + j]));
      gg = rt<T>(tanhf(p[3 * H + j]));
    }
    const float cn =
        rt<T>(rt<T>(fg * to_f(c_prev[b * ldcp + j])) + rt<T>(ig * gg));
    const float hn = rt<T>(og * rt<T>(tanhf(cn)));
    h_out[b * ldo + j] = from_f<T>(hn);
    c_out[b * ldo + j] = from_f<T>(cn);
  }
}

// ----------------------------------------------------------- backward ----

// The cell backward of step t from the pass-A pre-activations: writes the
// gate cotangents (rounded, in the pre-activations' gate positions) and
// carries dc; reads the dh carry (the previous launch's dh GEMM).
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
    const float* p = pre + b * ldpre;
    const float ig = sigmoidf_(p[j]);
    const float fg = sigmoidf_(p[H + j]);
    const int go = lstm ? 3 : 2, gg_ = lstm ? 2 : 3;  // o and g positions
    const float og = sigmoidf_(p[go * H + j]);
    const float gg = tanhf(p[gg_ * H + j]);
    const float tc = tanhf(to_f(c_t[b * ldc + j]));
    const float dh_t = dh[idx] + to_f(d_hall[b * ldc + j]);
    const float d_o = dh_t * tc * og * (1.0f - og);
    const float dc_t = dc[idx] + dh_t * og * (1.0f - tc * tc);
    const float d_f = dc_t * to_f(c_prev[b * ldcp + j]) * fg * (1.0f - fg);
    const float d_i = dc_t * gg * ig * (1.0f - ig);
    const float d_g = dc_t * ig * (1.0f - gg * gg);
    dc[idx] = dc_t * fg;
    T* out = dpre + b * lddp;
    out[j] = from_f<T>(d_i);
    out[H + j] = from_f<T>(d_f);
    out[go * H + j] = from_f<T>(d_o);
    out[gg_ * H + j] = from_f<T>(d_g);
  }
}

// d_alpha[p] = sum_e d_awe_raw[e] enc[p, e] + d_alphas[p]: one warp per
// pixel.  Grid (B, ceil(P / 8)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
train_dalpha_kernel(const T* __restrict__ enc, const T* __restrict__ d_awe_raw,
                    const float* __restrict__ d_alphas, long long ldda,
                    float* __restrict__ d_alpha, int P, int E) {
  extern __shared__ float g_s[];  // E
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int e = tid; e < E; e += blockDim.x)
    g_s[e] = to_f(d_awe_raw[(size_t)b * E + e]);
  __syncthreads();
  const int p = blockIdx.y * kWarps + (tid >> 5);
  if (p >= P) return;
  const T* row = enc + ((size_t)b * P + p) * E;
  float acc = 0.0f;
#pragma unroll 4
  for (int e = lane; e < E; e += 32) acc += g_s[e] * to_f(row[e]);
  acc = warp_sum(acc);
  if (lane == 0)
    d_alpha[(size_t)b * P + p] = acc + d_alphas[b * ldda + p];
}

constexpr int kColThreads = 128;
constexpr int kBwdCols = 64, kBwdSlices = 4, kBwdUnroll = 4;

// The softmax and relu-mask backward of step t.  Grid (ceil(A / 64), B),
// 256 threads: every block of an image recomputes the (tiny) softmax
// backward, then each of 64 attention columns is walked by 4 threads, one
// slice of the pixels each (p = slice mod 4), with four pixels' loads in
// flight; the slices' d_dec_raw sums add in slice order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
train_att_bwd_kernel(const T* __restrict__ ea, const T* __restrict__ dec,
                     long long lddec, const float* __restrict__ alphas,
                     long long ldal, const float* __restrict__ d_alpha,
                     const float* __restrict__ wf, float* __restrict__ d_ea,
                     float* __restrict__ wfdec, T* __restrict__ ddec,
                     long long ldddec, int P, int A) {
  extern __shared__ float smem[];
  float* d_att = smem;       // P
  float* d_att_t = smem + P; // P, rounded to T
  __shared__ float red[kWarps];
  __shared__ float part[kBwdSlices][kBwdCols];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* al = alphas + b * ldal;
  const float* da = d_alpha + (size_t)b * P;
  float inner = 0.0f;
  for (int p = tid; p < P; p += blockDim.x) inner += da[p] * al[p];
  inner = warp_sum(inner);
  if ((tid & 31) == 0) red[tid >> 5] = inner;
  __syncthreads();
  inner = 0.0f;
  for (int w = 0; w < kWarps; ++w) inner += red[w];
  for (int p = tid; p < P; p += blockDim.x) {
    const float v = al[p] * (da[p] - inner);
    d_att[p] = v;
    d_att_t[p] = rt<T>(v);
  }
  __syncthreads();
  const int c = tid % kBwdCols, sl = tid / kBwdCols;
  const int a = blockIdx.x * kBwdCols + c;
  float acc = 0.0f;
  float dec_a = 0.0f;
  if (a < A) {
    dec_a = to_f(dec[b * lddec + a]);
    const T* ea_b = ea + (size_t)b * P * A + a;
    float* dea_b = d_ea + (size_t)b * P * A + a;
    for (int p0 = sl; p0 < P; p0 += kBwdSlices * kBwdUnroll) {
      float x[kBwdUnroll], d[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int p = p0 + u * kBwdSlices;
        if (p < P) {
          x[u] = to_f(ea_b[(size_t)p * A]);
          d[u] = dea_b[(size_t)p * A];
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int p = p0 + u * kBwdSlices;
        if (p < P && rt<T>(x[u] + dec_a) > 0.0f) {
          dea_b[(size_t)p * A] = d[u] + d_att[p];
          acc += d_att_t[p];
        }
      }
    }
  }
  part[sl][c] = acc;
  __syncthreads();
  if (sl != 0 || a >= A) return;
  for (int k = 1; k < kBwdSlices; ++k) acc += part[k][c];
  wfdec[(size_t)b * A + a] += acc * dec_a;
  ddec[b * ldddec + a] = from_f<T>(acc * wf[a]);
}

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
// .) tensors are contiguous, time-major within an image.
struct TrainArgs {
  long long B, T, P, E, A, D, F4, lstm, esplit, split_cap;
  const void *enc, *ea, *emb_fac, *semx, *semh, *h0, *c0;
  const void *whcat, *bhcat, *wda, *bda, *wf, *wfb, *bfb, *wxa, *wh, *wxp,
      *whp, *bx, *bh;
  void *h_all, *c_all, *alphas, *awe_raw;  // forward out, backward in
  const void *h_prev, *d_hall, *d_alphas;  // backward in; h_prev (B*T, D)
  void *d_ea, *d_emb, *d_semx, *d_semh, *dh, *dc, *d_wf;  // backward out
  void *awe, *xfac, *hfac, *dpre, *dhfr, *dfb, *ddec;     // streams (B*T, .)
  // forward scratch: hall (B, A+E) f32, scores (B, P) f32, gawe (B, E),
  // xin/xfac/hfac (B, F4), pre (B, 4D) f32
  void *s_hall, *s_scores, *s_gawe, *s_xin, *s_xfac, *s_hfac, *s_pre;
  // backward scratch: dec (B*T, A), gate (B*T, E) f32, xin (B*T, F4),
  // hfac_raw (B*T, F4) f32, pre (B*T, 4D) f32, d_awe_raw (B, E),
  // d_alpha (B, P) f32, wfdec (B, A) f32, part (B, A) f32
  void *s_dec, *s_gate, *s_xin_all, *s_hfac_raw, *s_pre_all, *s_d_awe_raw,
      *s_d_alpha, *s_wfdec, *s_part;
  void* s_split;  // the GEMM's split-K partials, split_cap floats
};

#define IIC_TRY(x)            \
  do {                        \
    const int err_ = (x);     \
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

static inline void src(GemmArgs& g, int s, const void* a, long long lda,
                       const void* w, long long ldw, int k, int wt = 0) {
  g.a[s] = a;
  g.lda[s] = lda;
  g.w[s] = w;
  g.ldw[s] = ldw;
  g.k[s] = k;
  g.wt[s] = wt;
}

template <typename T>
static const T* at(const void* base, long long offset) {
  return (const T*)base + offset;
}

template <typename T>
static T* at(void* base, long long offset) {
  return (T*)base + offset;
}

static int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

template <typename T>
static int train_fwd(const TrainArgs& r, cudaStream_t s) {
  const int B = r.B, T_ = r.T, P = r.P, E = r.E, A = r.A, D = r.D;
  const int F4 = r.F4, H = D, F = F4 / 4, AE = A + E;
  const int lstm = (int)r.lstm;
  const size_t smem_sc = sizeof(float) * 2 * A, smem_at = sizeof(float) * 2 * P;
  IIC_TRY(allow_smem(train_scores_kernel<T>, smem_sc));
  IIC_TRY(allow_smem(train_attend_kernel<T>, smem_at));
  const int e_chunk = (E + (int)r.esplit - 1) / (int)r.esplit;
  for (int t = 0; t < T_; ++t) {
    const void* hp = t == 0 ? r.h0 : at<T>(r.h_all, (long long)(t - 1) * D);
    const void* cp = t == 0 ? r.c0 : at<T>(r.c_all, (long long)(t - 1) * D);
    const long long ldh = t == 0 ? D : (long long)T_ * D;
    GemmArgs g = gemm_args(r, B, AE, kEpiPre);
    src(g, 0, hp, ldh, r.whcat, AE, D);
    g.bias1 = r.bhcat;
    g.c = r.s_hall, g.ldc = AE, g.c_f32 = 1;
    IIC_TRY(launch_gemm<T>(g, 1, s));
    train_scores_kernel<T><<<dim3(B, (P + kWarps - 1) / kWarps), kThreads,
                             smem_sc, s>>>(
        (const T*)r.ea, (const float*)r.s_hall, AE, (const float*)r.wf,
        (float*)r.s_scores, P, A);
    IIC_TRY((int)cudaGetLastError());
    train_attend_kernel<T><<<dim3(B, r.esplit), kThreads, smem_at, s>>>(
        (const T*)r.enc, (const float*)r.s_scores, (const float*)r.s_hall, AE,
        A, at<float>(r.alphas, (long long)t * P), (long long)T_ * P,
        at<T>(r.awe_raw, (long long)t * E), (long long)T_ * E, (T*)r.s_gawe,
        P, E, e_chunk);
    IIC_TRY((int)cudaGetLastError());
    g = gemm_args(r, B, F4, kEpiAddMul);
    src(g, 0, r.s_gawe, E, r.wxa, F4, E);
    g.aux = at<T>(r.emb_fac, (long long)t * F4), g.ldaux = (long long)T_ * F4;
    g.c = r.s_xin, g.ldc = F4;
    if (!lstm) {
      g.aux2 = r.semx, g.ldaux2 = F4, g.aux2_div = 1;
      g.c2 = r.s_xfac, g.ldc2 = F4;
    }
    IIC_TRY(launch_gemm<T>(g, 1, s));
    if (!lstm) {
      g = gemm_args(r, B, F4, kEpiMul);
      src(g, 0, hp, ldh, r.wh, F4, D);
      g.aux = r.semh, g.ldaux = F4;
      g.c = r.s_hfac, g.ldc = F4;
      IIC_TRY(launch_gemm<T>(g, 1, s));
      g = gemm_args(r, B, H, kEpiPre);   // the four gates as gridDim.z
      src(g, 0, r.s_xfac, F4, r.wxp, H, F);
      src(g, 1, r.s_hfac, F4, r.whp, H, F);
      g.bias1 = r.bx, g.bias2 = r.bh;
      g.c = r.s_pre, g.ldc = 4 * H, g.c_f32 = 1;
      g.za = F, g.zw = (long long)F * H, g.zc = H, g.zb = H;
      IIC_TRY(launch_gemm<T>(g, 4, s));
    } else {
      g = gemm_args(r, B, 4 * H, kEpiPre);
      src(g, 0, hp, ldh, r.wh, 4 * H, D);
      g.bias1 = r.bx, g.bias2 = r.bh;
      g.aux = r.s_xin, g.ldaux = 4 * H;
      g.c = r.s_pre, g.ldc = 4 * H, g.c_f32 = 1;
      IIC_TRY(launch_gemm<T>(g, 1, s));
    }
    train_cell_kernel<T><<<blocks_for((long long)B * H, 256), 256, 0, s>>>(
        (const float*)r.s_pre, (const T*)cp, ldh,
        at<T>(r.h_all, (long long)t * D), at<T>(r.c_all, (long long)t * D),
        (long long)T_ * D, B, H, lstm);
    IIC_TRY((int)cudaGetLastError());
  }
  return 0;
}

template <typename T>
static int train_bwd(const TrainArgs& r, cudaStream_t s) {
  const int B = r.B, T_ = r.T, P = r.P, E = r.E, A = r.A, D = r.D;
  const int F4 = r.F4, H = D, F = F4 / 4, M = B * T_;
  const int lstm = (int)r.lstm;
  const long long TD = (long long)T_ * D, TP = (long long)T_ * P;
  const size_t smem_da = sizeof(float) * E, smem_ab = sizeof(float) * 2 * P;
  IIC_TRY(allow_smem(train_dalpha_kernel<T>, smem_da));
  IIC_TRY(allow_smem(train_att_bwd_kernel<T>, smem_ab));

  // ---- pass A: the recompute, at M = B*T rows ----
  GemmArgs g = gemm_args(r, M, A, kEpiBias);
  src(g, 0, r.h_prev, D, r.wda, A, D);
  g.bias1 = r.bda;
  g.c = r.s_dec, g.ldc = A;
  IIC_TRY(launch_gemm<T>(g, 1, s));
  g = gemm_args(r, M, E, kEpiGate);
  src(g, 0, r.h_prev, D, r.wfb, E, D);
  g.bias1 = r.bfb;
  g.aux = r.awe_raw, g.ldaux = E;
  g.c = r.s_gate, g.ldc = E, g.c_f32 = 1;
  g.c2 = r.awe, g.ldc2 = E;
  IIC_TRY(launch_gemm<T>(g, 1, s));
  g = gemm_args(r, M, F4, kEpiAddMul);
  src(g, 0, r.awe, E, r.wxa, F4, E);
  g.aux = r.emb_fac, g.ldaux = F4;
  g.c = r.s_xin_all, g.ldc = F4;
  if (!lstm) {
    g.aux2 = r.semx, g.ldaux2 = F4, g.aux2_div = T_;
    g.c2 = r.xfac, g.ldc2 = F4;
  }
  IIC_TRY(launch_gemm<T>(g, 1, s));
  if (!lstm) {
    g = gemm_args(r, M, F4, kEpiRawMul);
    src(g, 0, r.h_prev, D, r.wh, F4, D);
    g.aux2 = r.semh, g.ldaux2 = F4, g.aux2_div = T_;
    g.c = r.s_hfac_raw, g.ldc = F4, g.c_f32 = 1;
    g.c2 = r.hfac, g.ldc2 = F4;
    IIC_TRY(launch_gemm<T>(g, 1, s));
    g = gemm_args(r, M, H, kEpiPre);
    src(g, 0, r.xfac, F4, r.wxp, H, F);
    src(g, 1, r.hfac, F4, r.whp, H, F);
    g.bias1 = r.bx, g.bias2 = r.bh;
    g.c = r.s_pre_all, g.ldc = 4 * H, g.c_f32 = 1;
    g.za = F, g.zw = (long long)F * H, g.zc = H, g.zb = H;
    IIC_TRY(launch_gemm<T>(g, 4, s));
  } else {
    g = gemm_args(r, M, 4 * H, kEpiPre);
    src(g, 0, r.h_prev, D, r.wh, 4 * H, D);
    g.bias1 = r.bx, g.bias2 = r.bh;
    g.aux = r.s_xin_all, g.ldaux = 4 * H;
    g.c = r.s_pre_all, g.ldc = 4 * H, g.c_f32 = 1;
    IIC_TRY(launch_gemm<T>(g, 1, s));
  }

  // ---- the reverse scan ----
  for (int t = T_ - 1; t >= 0; --t) {
    const void* cp = t == 0 ? r.c0 : at<T>(r.c_all, (long long)(t - 1) * D);
    train_cell_bwd_kernel<T><<<blocks_for((long long)B * H, 256), 256, 0,
                               s>>>(
        at<float>(r.s_pre_all, (long long)t * 4 * H), (long long)T_ * 4 * H,
        at<T>(r.c_all, (long long)t * D), (const T*)cp, t == 0 ? D : TD,
        at<T>(r.d_hall, (long long)t * D), TD, (const float*)r.dh,
        (float*)r.dc, at<T>(r.dpre, (long long)t * 4 * H),
        (long long)T_ * 4 * H, B, H, lstm);
    IIC_TRY((int)cudaGetLastError());
    const void* dpre_t = at<T>(r.dpre, (long long)t * 4 * H);
    const void* dxin = dpre_t;
    long long lddx = (long long)T_ * 4 * H;
    if (!lstm) {
      const long long ldf = (long long)T_ * F4;
      for (int branch = 0; branch < 2; ++branch) {
        // x: d_emb = rt(d_xfac semx), d_semx += d_xfac xin
        // h: dhfr = rt(d_hfac semh),  d_semh += d_hfac hfac_raw
        g = gemm_args(r, B, F, kEpiFacBwd);
        src(g, 0, dpre_t, (long long)T_ * 4 * H, branch ? r.whp : r.wxp, H,
            H, /*wt=*/1);
        g.za = H, g.zw = (long long)F * H, g.zc = F;
        g.aux = branch ? r.semh : r.semx, g.ldaux = F4;
        g.aux2 = branch ? (const void*)at<float>(r.s_hfac_raw,
                                                 (long long)t * F4)
                        : (const void*)at<T>(r.s_xin_all, (long long)t * F4);
        g.ldaux2 = ldf, g.aux2_div = 1, g.aux2_f32 = branch;
        g.acc = (float*)(branch ? r.d_semh : r.d_semx), g.ldacc = F4;
        g.c = branch ? at<T>(r.dhfr, (long long)t * F4)
                     : at<T>(r.d_emb, (long long)t * F4);
        g.ldc = ldf;
        IIC_TRY(launch_gemm<T>(g, 4, s));
      }
      dxin = at<T>(r.d_emb, (long long)t * F4);
      lddx = ldf;
    }
    // d_awe = d_xin @ wxa^T -> dfb, d_awe_raw
    g = gemm_args(r, B, E, kEpiGateBwd);
    src(g, 0, dxin, lddx, r.wxa, F4, F4, /*wt=*/1);
    g.aux = at<T>(r.awe_raw, (long long)t * E), g.ldaux = (long long)T_ * E;
    g.aux2 = at<float>(r.s_gate, (long long)t * E);
    g.ldaux2 = (long long)T_ * E, g.aux2_div = 1, g.aux2_f32 = 1;
    g.c = at<T>(r.dfb, (long long)t * E), g.ldc = (long long)T_ * E;
    g.c2 = r.s_d_awe_raw, g.ldc2 = E;
    IIC_TRY(launch_gemm<T>(g, 1, s));
    train_dalpha_kernel<T><<<dim3(B, (P + kWarps - 1) / kWarps), kThreads,
                             smem_da, s>>>(
        (const T*)r.enc, (const T*)r.s_d_awe_raw,
        at<float>(r.d_alphas, (long long)t * P), TP, (float*)r.s_d_alpha, P,
        E);
    IIC_TRY((int)cudaGetLastError());
    train_att_bwd_kernel<T><<<dim3((A + kBwdCols - 1) / kBwdCols, B),
                              kThreads, smem_ab, s>>>(
        (const T*)r.ea, at<T>(r.s_dec, (long long)t * A), (long long)T_ * A,
        at<float>(r.alphas, (long long)t * P), TP,
        (const float*)r.s_d_alpha, (const float*)r.wf, (float*)r.d_ea,
        (float*)r.s_wfdec, at<T>(r.ddec, (long long)t * A), (long long)T_ * A,
        P, A);
    IIC_TRY((int)cudaGetLastError());
    // dh = [dhfr | dfb | ddec] @ [wh ; wfb ; wda]^T  (LSTM: dpre for dhfr)
    g = gemm_args(r, B, D, kEpiPre);
    if (!lstm)
      src(g, 0, at<T>(r.dhfr, (long long)t * F4), (long long)T_ * F4, r.wh,
          F4, F4, /*wt=*/1);
    else
      src(g, 0, dpre_t, (long long)T_ * 4 * H, r.wh, 4 * H, 4 * H, 1);
    src(g, 1, at<T>(r.dfb, (long long)t * E), (long long)T_ * E, r.wfb, E, E,
        1);
    src(g, 2, at<T>(r.ddec, (long long)t * A), (long long)T_ * A, r.wda, A,
        A, 1);
    g.c = r.dh, g.ldc = D, g.c_f32 = 1;
    IIC_TRY(launch_gemm<T>(g, 1, s));
  }

  // ---- finalize: the wf gradient and d_ea *= wf ----
  const dim3 grid_a((A + kColThreads - 1) / kColThreads, B);
  train_wf_part_kernel<T><<<grid_a, kColThreads, 0, s>>>(
      (float*)r.d_ea, (const T*)r.ea, (const float*)r.wf,
      (const float*)r.s_wfdec, (float*)r.s_part, P, A);
  IIC_TRY((int)cudaGetLastError());
  train_wf_sum_kernel<<<blocks_for(A, kColThreads), kColThreads, 0, s>>>(
      (const float*)r.s_part, (float*)r.d_wf, B, A);
  return (int)cudaGetLastError();
}

}  // namespace iic

extern "C" int iic_train_args_bytes() { return (int)sizeof(iic::TrainArgs); }

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
