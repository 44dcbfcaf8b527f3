// Kernel 7: S beam decode steps with the beam selection on the card.
//
// Replaces indonesian_image_captioning_tpu/ops/span_pallas.py
// fused_decode_span (body _make_kernel): S consecutive beam steps over
// R = B*K rows, both cells (attention_scn's SCN, pure_attention's torch
// LSTM).  It emits per-step selection records -- words and parents
// (B, S, K) int32, vals (B, S, K) float32 -- that decode/replay.py turns
// into beams.  (Kernel 13, the whole decode, runs on step.cu's chain.)
//
// One step is kernel 2's math with the beam bookkeeping added at both
// ends:
//
//   gather  emb[r] = table[pw[r]]               (ids stay int32)
//   the step: dec, attention (attend.cuh), gate, cell GEMMs, cell, head
//           GEMM, head top-K (the tensor-core GEMM of mma.cuh, step.cuh)
//   select  one block per image (step.cuh select_kernel): the K*K
//           candidates cand = max(sc + (topv - lse), NEG), NEG where
//           sc <= NEG, K rounds of max / lowest-flat-index argmax / mask
//           with NEG (lax.top_k's order; each round looks past the last
//           winner, so any K), the records at [b, step, k], the
//           bookkeeping of span_pallas.py:487-494 (valid = lane < alive
//           and val > NEG; alive -= ends; sc = val where the lane goes on,
//           else NEG; pw = word) and the (h, c) reorder by parent, a gather
//           from the cell's output buffers into the carried state.
//
// What the TPU kernel carries and this one does not: the one-hot MXU
// contractions that move ids, scores and the parent reorder (here plain
// indexed loads and stores, exact by construction), the 3-limb bf16
// embedding table (here a row gather), the 16-pixel padding and the VMEM
// tile plans.
//
// What bounds it: the step's chain, as kernel 2's (step.cu): the head GEMM
// is the largest arithmetic term and the encoder state the largest byte
// term; the gather and the selection add about R * Emb + B * K * K values
// per step.  What the design does about it: the host makes one call per
// span instead of one per step, the selection and the reorder run on the
// card, and the driver reads the alive counts once per span.  Its
// products (dec, the gate, the SCN factors and gates or the LSTM gates,
// the head) run on the tensor cores (mma.cuh: bf16 wgmma, 3xTF32 at
// float32), split over K where their output tiles do not fill the card,
// with the scratch s_part for the partials.
#include <type_traits>

#include "attend.cuh"
#include "mma.cuh"
#include "step.cuh"

namespace iic {

// emb (R, Emb) = table (V, Emb)[pw]; an id outside [0, V) stops the kernel
// (the head's top-K never yields one).
template <typename T>
__global__ void gather_kernel(const T* __restrict__ table,
                              const int* __restrict__ pw, T* __restrict__ emb,
                              int R, int Emb, int V) {
  const long long n = (long long)R * Emb;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(idx / Emb);
    const int j = (int)(idx % Emb);
    const int id = pw[r];
    if ((unsigned)id >= (unsigned)V) __trap();
    emb[idx] = table[(long long)id * Emb + j];
  }
}

// ---------------------------------------------------------- host loop ----

// Everything one call needs (unused pointers null).  Every field is 8
// bytes; ops/span_cuda.py mirrors it field for field and checks its size
// against iic_span_args_bytes().  Shapes: enc (B, P, E), ea (B, P, A),
// semx/semh (R, F4), emb_tab (V, Emb), h/c (R, D), sc/pw (R,), alive (B,),
// records (B, rec_steps, K); weights as ops/step_cuda.py pack_step_weights.
struct SpanArgs {
  long long B, K, P, E, A, D, Emb, F4, V, steps, rec_steps, lstm, end_id,
      part_cap;
  AttendPlan att;   // ops/attention_cuda.py attend_plan
  const void *enc, *ea, *semx, *semh, *emb_tab;
  const void *bda, *wf, *bfb, *bx, *bh, *fcb;
  // the products' weights for the tensor-core GEMM (step_cuda.pack_tc):
  // transposed to (N, K) -- the gates' per gate, (4H, F) -- and at float32
  // split into TF32 hi parts (*_t) and lo parts (*_tlo, null at bf16)
  const void *wda_t, *wfb_t, *wxe_t, *wxa_t, *wh_t, *wxp_t, *whp_t, *wih_t,
      *fcw_t;
  const void *wda_tlo, *wfb_tlo, *wxe_tlo, *wxa_tlo, *wh_tlo, *wxp_tlo,
      *whp_tlo, *wih_tlo, *fcw_tlo;
  const void *h_in, *c_in, *sc_in, *pw_in, *alive_in;  // the state on entry
  void *h, *c, *sc, *pw, *alive;                       // ... and on return
  void *words, *parents, *vals;
  // scratch: emb (R, Emb), dec (R, A), awe and gawe
  // (R, E), xfac/hfac (R, F4), pre (R, 4D) f32, hnew/cnew (R, D), logits
  // (R, V) f32, topv (R, K) f32, topi (R, K) int32, lse (R,) f32, and
  // part_cap float32 for the GEMM's split-K partials
  void *s_emb, *s_dec, *s_awe, *s_gawe, *s_xfac, *s_hfac, *s_pre,
      *s_hnew, *s_cnew, *s_logits, *s_topv, *s_topi, *s_lse, *s_part;
};

#define IIC_TRY(x)              \
  do {                          \
    const int err_ = (x);       \
    if (err_ != 0) return err_; \
  } while (0)

static inline GemmArgs gemm_args(const SpanArgs& r, int M, int N, int epi,
                                 void* c, long long ldc, int c_f32) {
  GemmArgs g = {};
  g.part = (float*)r.s_part;
  g.part_cap = r.part_cap;
  g.M = M;
  g.N = N;
  g.epi = epi;
  g.c = c;
  g.ldc = ldc;
  g.c_f32 = c_f32;
  return g;
}

// Source s: a (M, k) with row stride lda times the weight stored (N, k)
// with row stride ldw (w_t, and its lo parts w_tlo at float32).
static inline void src(GemmArgs& g, int s, const void* a, long long lda,
                       const void* w_t, const void* w_tlo, long long ldw,
                       int k) {
  g.a[s] = a;
  g.lda[s] = lda;
  g.w[s] = w_t;
  g.w_lo[s] = w_tlo;
  g.wt[s] = 1;
  g.ldw[s] = ldw;
  g.k[s] = k;
}

// p + off elements of T (the lo parts are float32), or null.
template <typename T>
static inline const void* at(const void* p, long long off) {
  return p == nullptr ? nullptr : (const T*)p + off;
}

template <typename T>
static int run_steps(const SpanArgs& r, cudaStream_t st) {
  const int B = r.B, K = r.K, P = r.P, E = r.E, A = r.A, D = r.D;
  const int Emb = r.Emb, F4 = r.F4, V = r.V, H = D, F = F4 / 4;
  const int R = B * K, lstm = (int)r.lstm;
  const int gather_blocks = (int)(((long long)R * Emb + 255) / 256);
  for (int s = 0; s < r.steps; ++s) {
    const void* h = s == 0 ? r.h_in : r.h;
    const void* c = s == 0 ? r.c_in : r.c;
    const float* sc = (const float*)(s == 0 ? r.sc_in : r.sc);
    const int* pw = (const int*)(s == 0 ? r.pw_in : r.pw);
    const int* alive = (const int*)(s == 0 ? r.alive_in : r.alive);

    gather_kernel<T><<<gather_blocks, 256, 0, st>>>(
        (const T*)r.emb_tab, pw, (T*)r.s_emb, R, Emb, V);
    IIC_TRY((int)cudaGetLastError());
    GemmArgs g = gemm_args(r, R, A, kEpiBias, r.s_dec, A, 0);
    src(g, 0, h, D, r.wda_t, r.wda_tlo, D, D);
    g.bias1 = r.bda;
    IIC_TRY(launch_gemm_tc<T>(g, 1, st));
    IIC_TRY(launch_attend<T>(r.enc, r.ea, r.s_dec, r.wf, r.s_awe, nullptr, B,
                             K, P, E, A, r.att, st));
    g = gemm_args(r, R, E, kEpiSigmoidMul, r.s_gawe, E, 0);
    src(g, 0, h, D, r.wfb_t, r.wfb_tlo, D, D);
    g.bias1 = r.bfb;
    g.aux = r.s_awe;
    g.ldaux = E;
    IIC_TRY(launch_gemm_tc<T>(g, 1, st));
    if (!lstm) {
      g = gemm_args(r, R, F4, kEpiMul, r.s_xfac, F4, 0);
      src(g, 0, r.s_emb, Emb, r.wxe_t, r.wxe_tlo, Emb, Emb);
      src(g, 1, r.s_gawe, E, r.wxa_t, r.wxa_tlo, E, E);
      g.aux = r.semx;
      g.ldaux = F4;
      IIC_TRY(launch_gemm_tc<T>(g, 1, st));
      g = gemm_args(r, R, F4, kEpiMul, r.s_hfac, F4, 0);
      src(g, 0, h, D, r.wh_t, r.wh_tlo, D, D);
      g.aux = r.semh;
      g.ldaux = F4;
      IIC_TRY(launch_gemm_tc<T>(g, 1, st));
      // the four gates as gridDim.z, as step_cuda.launch_step
      g = gemm_args(r, R, H, kEpiPre, r.s_pre, 4 * H, 1);
      src(g, 0, r.s_xfac, F4, r.wxp_t, r.wxp_tlo, F, F);
      src(g, 1, r.s_hfac, F4, r.whp_t, r.whp_tlo, F, F);
      g.bias1 = r.bx;
      g.bias2 = r.bh;
      g.za = F;
      g.zw = (long long)F * H;
      g.zc = H;
      g.zb = H;
      IIC_TRY(launch_gemm_tc<T>(g, 4, st));
    } else {
      // [emb | gawe] @ wih + h @ wh: the concatenated input as two sources
      g = gemm_args(r, R, 4 * H, kEpiPre, r.s_pre, 4 * H, 1);
      src(g, 0, r.s_emb, Emb, r.wih_t, r.wih_tlo, Emb + E, Emb);
      src(g, 1, r.s_gawe, E, at<T>(r.wih_t, Emb), at<float>(r.wih_tlo, Emb),
          Emb + E, E);
      src(g, 2, h, D, r.wh_t, r.wh_tlo, D, D);
      g.bias1 = r.bx;
      g.bias2 = r.bh;
      IIC_TRY(launch_gemm_tc<T>(g, 1, st));
    }
    IIC_TRY(launch_cell<T>(r.s_pre, c, r.s_hnew, r.s_cnew, R, H, lstm, st));
    g = gemm_args(r, R, V, kEpiBias, r.s_logits, V, 1);
    src(g, 0, r.s_hnew, D, r.fcw_t, r.fcw_tlo, D, D);
    g.bias1 = r.fcb;
    IIC_TRY(launch_gemm_tc<T>(g, 1, st));
    IIC_TRY(launch_head(r.s_logits, R, V, K, r.s_topv, r.s_topi, r.s_lse, 0,
                        st));

    SelectArgs a = {};
    a.topv = (const float*)r.s_topv;
    a.topi = (const int*)r.s_topi;
    a.lse = (const float*)r.s_lse;
    a.sc_in = sc;
    a.pw_in = pw;
    a.alive_in = alive;
    a.sc = (float*)r.sc;
    a.pw = (int*)r.pw;
    a.alive = (int*)r.alive;
    a.h_new = r.s_hnew;
    a.c_new = r.s_cnew;
    a.h_src = h;
    a.c_src = c;
    a.h = r.h;
    a.c = r.c;
    a.words = (int*)r.words;
    a.parents = (int*)r.parents;
    a.vals = (float*)r.vals;
    a.K = K;
    a.D = D;
    a.end_id = (int)r.end_id;
    a.step = s;
    a.rec_steps = (int)r.rec_steps;
    select_kernel<T><<<B, kSelectThreads, 0, st>>>(a);
    IIC_TRY((int)cudaGetLastError());
  }
  return 0;
}

static int valid(const SpanArgs& r) {
  return r.B >= 1 && r.K >= 1 && r.K <= r.V && r.P >= 1 &&
         r.steps >= 1 && r.rec_steps >= r.steps && r.F4 % 4 == 0;
}

template <typename F_>
static int dispatch(int dtype, F_ f) {
  if (dtype == kF32) return f((float*)nullptr);
  if (dtype == kBF16) return f((__nv_bfloat16*)nullptr);
  return (int)cudaErrorInvalidValue;
}

}  // namespace iic

extern "C" int iic_span_args_bytes() { return (int)sizeof(iic::SpanArgs); }

// The tensor-core GEMM's launches by this library since the last call
// (ops/span_cuda.py adds them to step_cuda.gemm.launches after each call).
extern "C" int iic_tc_launches_take() {
  const int n = iic::tc_launches;
  iic::tc_launches = 0;
  return n;
}

// Kernel 7: r.steps beam steps, both cells.  Returns the first failing
// launch's CUDA error code, 0 on success.
extern "C" int iic_span(int dtype, const void* args, void* stream) {
  const iic::SpanArgs& r = *(const iic::SpanArgs*)args;
  if (!iic::valid(r)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return iic::dispatch(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return iic::run_steps<T>(r, s);
  });
}
