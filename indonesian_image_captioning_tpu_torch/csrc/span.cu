// Kernels 7 and 13: beam decode steps with the beam selection on the card.
//
// Kernel 7 replaces indonesian_image_captioning_tpu/ops/span_pallas.py
// fused_decode_span (body _make_kernel): S consecutive beam steps over
// R = B*K rows, both cells (attention_scn's SCN, pure_attention's torch
// LSTM).  Kernel 13 replaces ops/decode_pallas.py beam_decode_records
// (body _make_kernel): all T steps of attention_scn in one call.  Both
// emit per-step selection records -- words and parents (B, ., K) int32,
// vals (B, ., K) float32 -- that decode/replay.py turns into beams.
//
// One step is kernel 2's chain (step.cu) with the beam bookkeeping added
// at both ends:
//
//   gather  emb[r] = table[pw[r]]               (ids stay int32)
//   kernel 2's chain: dec, attention (attend.cuh), gate, cell GEMMs,
//           cell, head GEMM, head top-K (gemm.cuh, step.cuh)
//   select  one block per image: the K*K candidates
//           cand = max(sc + (topv - lse), NEG), NEG where sc <= NEG,
//           K rounds of max / lowest-flat-index argmax / mask with NEG
//           (lax.top_k's order), the records at [b, step, k], the
//           bookkeeping of span_pallas.py:487-494 (valid = lane < alive
//           and val > NEG; alive -= ends; sc = val where the lane goes on,
//           else NEG; pw = word) and the (h, c) reorder by parent, a gather
//           from the cell's output buffers into the carried state.
//
// The megakernel differs where its Pallas body does: its head keeps the
// raw logits (lse = log sum exp(x - max) + max, topv = x - lse;
// decode_pallas.py:223-234), and an image whose lanes are all dead at the
// start of a step is frozen (act_r, decode_pallas.py:275-293): its state
// and scores stay, its alive count stays 0.  Its early exit reads no value
// on the host: every selection ORs "this image is alive" into the step's
// word live[t + 1] (live[0] = 1, the rest 0 on entry), and every kernel of
// step t + 1 returns at once when live[t + 1] is 0.  The records of a step
// that did not run keep what the caller put there (words 0, parents 0,
// vals NEG).  The TPU kernel exits per image chunk and leaves the records
// of a skipped chunk unwritten; here the exit is for the whole batch.
//
// What the TPU kernels carry and this one does not: the one-hot MXU
// contractions that move ids, scores and the parent reorder (here plain
// indexed loads and stores, exact by construction), the 3-limb bf16
// embedding table (here a row gather), the 16-pixel padding and the VMEM
// tile plans.
//
// What bounds it: the step's chain, as kernel 2's (step.cu): the head GEMM
// is the largest arithmetic term and the encoder state the largest byte
// term; the gather and the selection add about R * Emb + B * K * K values
// per step.  What the design does about it: the host makes one call per
// span (kernel 7) or per decode (kernel 13) instead of one per step, the
// selection and the reorder run on the card, and kernel 7's driver reads
// the alive counts once per span.  The step chain itself is kernel 2's.
#include <type_traits>

#include "attend.cuh"
#include "gemm.cuh"
#include "step.cuh"

namespace iic {

constexpr int kSelectThreads = 128;

// emb (R, Emb) = table (V, Emb)[pw]; an id outside [0, V) stops the kernel
// (the head's top-K never yields one).
template <typename T>
__global__ void gather_kernel(const T* __restrict__ table,
                              const int* __restrict__ pw, T* __restrict__ emb,
                              int R, int Emb, int V, const int* live) {
  if (skip(live)) return;
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

struct SelectArgs {
  const float* topv;     // (R, K) float32
  const int* topi;       // (R, K)
  const float* lse;      // (R,), or null when topv holds log-probabilities
  const float* sc_in;    // (R,) the scores before the step
  const int* pw_in;      // (R,)
  const int* alive_in;   // (B,)
  float* sc;             // (R,) after the step (may equal sc_in)
  int* pw;
  int* alive;
  const void* h_new;     // (R, D) the cell's output
  const void* c_new;
  const void* h_src;     // (R, D) the state before the step
  const void* c_src;
  void* h;               // (R, D) the state after the step (may equal h_src)
  void* c;
  int* words;            // (B, rec_steps, K)
  int* parents;
  float* vals;
  int K, D, end_id, freeze, step, rec_steps;
  const int* live_in;    // this step's early-exit word, or null
  int* live_out;         // the next step's, or null
};

// One block per image.
template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
select_kernel(SelectArgs a) {
  if (skip(a.live_in)) return;
  __shared__ float cand[kMaxK * kMaxK];
  __shared__ int cid[kMaxK * kMaxK];
  __shared__ float s_val[kMaxK];
  __shared__ int s_flat[kMaxK];
  __shared__ int s_lane[kMaxK];
  __shared__ int s_upd;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int K = a.K, KK = K * K, D = a.D;

  for (int j = tid; j < KK; j += blockDim.x) {
    const int r = b * K + j / K;
    const int q = j % K;
    const float s = a.sc_in[r];
    const float lp = a.lse != nullptr ? a.topv[r * K + q] - a.lse[r]
                                      : a.topv[r * K + q];
    float v = fmaxf(s + lp, kNeg);
    if (s <= kNeg) v = kNeg;
    cand[j] = v;
    cid[j] = a.topi[r * K + q];
  }
  __syncthreads();

  // K rounds over the K*K candidates in warp 0: the largest value, ties to
  // the lowest flat index, masked with NEG before the next round.
  if (tid < 32) {
    for (int q = 0; q < K; ++q) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int j = tid; j < KK; j += 32) {
        const float v = cand[j];
        if (v > bv || (v == bv && j < bi)) {
          bv = v;
          bi = j;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (tid == 0) {
        s_val[q] = bv;
        s_flat[q] = bi;
        cand[bi] = kNeg;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  if (tid == 0) {
    const int al = a.alive_in[b];
    const int upd = !a.freeze || al > 0;
    int n_done = 0;
    for (int k = 0; k < K; ++k) {
      const float tv = s_val[k];
      const int flat = s_flat[k];
      const int word = cid[flat];
      const long long ri = ((long long)b * a.rec_steps + a.step) * K + k;
      a.words[ri] = word;
      a.parents[ri] = flat / K;
      a.vals[ri] = tv;
      s_lane[k] = flat / K;
      const int r = b * K + k;
      if (upd) {
        const bool valid = k < al && tv > kNeg;
        const bool is_end = valid && word == a.end_id;
        n_done += is_end;
        a.sc[r] = (valid && !is_end) ? tv : kNeg;
        a.pw[r] = word;
      } else {
        a.sc[r] = a.sc_in[r];
        a.pw[r] = a.pw_in[r];
      }
    }
    const int na = al - n_done;
    a.alive[b] = na;
    if (a.live_out != nullptr && na > 0) atomicOr(a.live_out, 1);
    s_upd = upd;
  }
  __syncthreads();

  // The reorder: lane k of the image takes its parent's new (h, c); a
  // frozen image keeps its state.  Rows are read from buffers the step
  // wrote and written to the carried state, never in place.
  const bool upd = s_upd != 0;
  if (!upd && a.h == a.h_src) return;
  const T* hs = (const T*)(upd ? a.h_new : a.h_src);
  const T* cs = (const T*)(upd ? a.c_new : a.c_src);
  T* h = (T*)a.h;
  T* c = (T*)a.c;
  for (int idx = tid; idx < K * D; idx += blockDim.x) {
    const int k = idx / D;
    const int j = idx % D;
    const long long src = (long long)(b * K + (upd ? s_lane[k] : k)) * D + j;
    const long long dst = (long long)(b * K + k) * D + j;
    h[dst] = hs[src];
    c[dst] = cs[src];
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
      esplit;
  const void *enc, *ea, *semx, *semh, *emb_tab;
  const void *wda, *bda, *wf, *wfb, *bfb, *wxe, *wxa, *wh, *wxp, *whp, *wih,
      *bx, *bh, *fcw, *fcb;
  const void *h_in, *c_in, *sc_in, *pw_in, *alive_in;  // the state on entry
  void *h, *c, *sc, *pw, *alive;                       // ... and on return
  void *words, *parents, *vals;
  void* live;  // int (steps + 1): the megakernel's early-exit words
  // scratch: emb (R, Emb), dec (R, A), scores (B, K, P) f32, awe and gawe
  // (R, E), xfac/hfac (R, F4), pre (R, 4D) f32, hnew/cnew (R, D), logits
  // (R, V) f32, topv (R, K) f32, topi (R, K) int32, lse (R,) f32
  void *s_emb, *s_dec, *s_scores, *s_awe, *s_gawe, *s_xfac, *s_hfac, *s_pre,
      *s_hnew, *s_cnew, *s_logits, *s_topv, *s_topi, *s_lse;
};

#define IIC_TRY(x)              \
  do {                          \
    const int err_ = (x);       \
    if (err_ != 0) return err_; \
  } while (0)

static inline GemmArgs gemm_args(int M, int N, int epi, void* c,
                                 long long ldc, int c_f32, const int* live) {
  GemmArgs g = {};
  g.M = M;
  g.N = N;
  g.epi = epi;
  g.c = c;
  g.ldc = ldc;
  g.c_f32 = c_f32;
  g.live = live;
  return g;
}

static inline void src(GemmArgs& g, int s, const void* a, long long lda,
                       const void* w, long long ldw, int k) {
  g.a[s] = a;
  g.lda[s] = lda;
  g.w[s] = w;
  g.ldw[s] = ldw;
  g.k[s] = k;
}

// raw_head / freeze / early exit: 0 / 0 / no for kernel 7, 1 / 1 / yes for
// kernel 13.
template <typename T>
static int run_steps(const SpanArgs& r, int raw_head, int freeze,
                     cudaStream_t st) {
  const int B = r.B, K = r.K, P = r.P, E = r.E, A = r.A, D = r.D;
  const int Emb = r.Emb, F4 = r.F4, V = r.V, H = D, F = F4 / 4;
  const int R = B * K, lstm = (int)r.lstm;
  const int gather_blocks = (int)(((long long)R * Emb + 255) / 256);
  for (int s = 0; s < r.steps; ++s) {
    const int* live = r.live ? (const int*)r.live + s : nullptr;
    const void* h = s == 0 ? r.h_in : r.h;
    const void* c = s == 0 ? r.c_in : r.c;
    const float* sc = (const float*)(s == 0 ? r.sc_in : r.sc);
    const int* pw = (const int*)(s == 0 ? r.pw_in : r.pw);
    const int* alive = (const int*)(s == 0 ? r.alive_in : r.alive);

    gather_kernel<T><<<gather_blocks, 256, 0, st>>>(
        (const T*)r.emb_tab, pw, (T*)r.s_emb, R, Emb, V, live);
    IIC_TRY((int)cudaGetLastError());
    GemmArgs g = gemm_args(R, A, kEpiBias, r.s_dec, A, 0, live);
    src(g, 0, h, D, r.wda, A, D);
    g.bias1 = r.bda;
    IIC_TRY(launch_gemm<T>(g, 1, st));
    IIC_TRY(launch_attend<T>(r.enc, r.ea, r.s_dec, r.wf, r.s_scores, r.s_awe,
                             nullptr, B, K, P, E, A, (int)r.esplit, st,
                             live));
    g = gemm_args(R, E, kEpiSigmoidMul, r.s_gawe, E, 0, live);
    src(g, 0, h, D, r.wfb, E, D);
    g.bias1 = r.bfb;
    g.aux = r.s_awe;
    g.ldaux = E;
    IIC_TRY(launch_gemm<T>(g, 1, st));
    if (!lstm) {
      g = gemm_args(R, F4, kEpiMul, r.s_xfac, F4, 0, live);
      src(g, 0, r.s_emb, Emb, r.wxe, F4, Emb);
      src(g, 1, r.s_gawe, E, r.wxa, F4, E);
      g.aux = r.semx;
      g.ldaux = F4;
      IIC_TRY(launch_gemm<T>(g, 1, st));
      g = gemm_args(R, F4, kEpiMul, r.s_hfac, F4, 0, live);
      src(g, 0, h, D, r.wh, F4, D);
      g.aux = r.semh;
      g.ldaux = F4;
      IIC_TRY(launch_gemm<T>(g, 1, st));
      // the four gates as gridDim.z, as step_cuda.launch_step
      g = gemm_args(R, H, kEpiPre, r.s_pre, 4 * H, 1, live);
      src(g, 0, r.s_xfac, F4, r.wxp, H, F);
      src(g, 1, r.s_hfac, F4, r.whp, H, F);
      g.bias1 = r.bx;
      g.bias2 = r.bh;
      g.za = F;
      g.zw = (long long)F * H;
      g.zc = H;
      g.zb = H;
      IIC_TRY(launch_gemm<T>(g, 4, st));
    } else {
      // [emb | gawe] @ wih + h @ wh: the concatenated input as two sources
      g = gemm_args(R, 4 * H, kEpiPre, r.s_pre, 4 * H, 1, live);
      src(g, 0, r.s_emb, Emb, r.wih, 4 * H, Emb);
      src(g, 1, r.s_gawe, E, (const T*)r.wih + (long long)Emb * 4 * H, 4 * H,
          E);
      src(g, 2, h, D, r.wh, 4 * H, D);
      g.bias1 = r.bx;
      g.bias2 = r.bh;
      IIC_TRY(launch_gemm<T>(g, 1, st));
    }
    IIC_TRY(launch_cell<T>(r.s_pre, c, r.s_hnew, r.s_cnew, R, H, lstm, st,
                           live));
    g = gemm_args(R, V, kEpiBias, r.s_logits, V, 1, live);
    src(g, 0, r.s_hnew, D, r.fcw, V, D);
    g.bias1 = r.fcb;
    IIC_TRY(launch_gemm<T>(g, 1, st));
    IIC_TRY(launch_head(r.s_logits, R, V, K, r.s_topv, r.s_topi, r.s_lse,
                        raw_head, st, live));

    SelectArgs a = {};
    a.topv = (const float*)r.s_topv;
    a.topi = (const int*)r.s_topi;
    a.lse = raw_head ? nullptr : (const float*)r.s_lse;
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
    a.freeze = freeze;
    a.step = s;
    a.rec_steps = (int)r.rec_steps;
    a.live_in = live;
    a.live_out = r.live ? (int*)r.live + s + 1 : nullptr;
    select_kernel<T><<<B, kSelectThreads, 0, st>>>(a);
    IIC_TRY((int)cudaGetLastError());
  }
  return 0;
}

static int valid(const SpanArgs& r) {
  return r.B >= 1 && r.K >= 1 && r.K <= kMaxK && r.K <= r.V && r.P >= 1 &&
         r.steps >= 1 && r.rec_steps >= r.steps && r.F4 % 4 == 0 &&
         r.esplit >= 1;
}

template <typename F_>
static int dispatch(int dtype, F_ f) {
  if (dtype == kF32) return f((float*)nullptr);
  if (dtype == kBF16) return f((__nv_bfloat16*)nullptr);
  return (int)cudaErrorInvalidValue;
}

}  // namespace iic

extern "C" int iic_span_args_bytes() { return (int)sizeof(iic::SpanArgs); }

// Kernel 7: r.steps beam steps, both cells.  Returns the first failing
// launch's CUDA error code, 0 on success.
extern "C" int iic_span(int dtype, const void* args, void* stream) {
  const iic::SpanArgs& r = *(const iic::SpanArgs*)args;
  if (!iic::valid(r) || r.live != nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return iic::dispatch(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return iic::run_steps<T>(r, 0, 0, s);
  });
}

// Kernel 13: every step of an attention_scn decode, with the early exit on
// the card (r.live: steps + 1 words, 1 then zeros).
extern "C" int iic_decode_records(int dtype, const void* args, void* stream) {
  const iic::SpanArgs& r = *(const iic::SpanArgs*)args;
  if (!iic::valid(r) || r.live == nullptr || r.lstm != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return iic::dispatch(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return iic::run_steps<T>(r, 1, 1, s);
  });
}
