// Kernels 2, 6b and 6c: one fused beam-decode step over R = B*K rows, and
// its C entry point iic_step (one call a step); kernel 13: the whole
// decode on the same chain, captured once into a CUDA graph
// (iic_decode_capture, iic_decode_launch).
//
// Replaces indonesian_image_captioning_tpu/ops/step_pallas.py
// fused_decode_step, fused_decode_step_q and fused_decode_step_noattn
// (body _make_kernel, call _fused_call).  The Pallas body is one kernel;
// here the step is a short chain of launches on one stream, driven from
// this file by iic_step, with the scratch and packed weights of
// ops/step_cuda.py.  "small" is the swap-AB tensor-core GEMM of
// mma_small.cuh at its wide batch tile (kSmWide = 160 rows: the whole beam
// batch at B = 32, K = 5), on K-major packs (step_cuda.step_packs);
// rt() rounds through the working type T where the body casts
// (step_pallas.py:249-324, 343-370):
//
//   L1 small  h @ [wda | wfb | wh]: dec = rt(rt(v) + bda),
//             g = rt(sigmoid(rt(rt(v) + bfb))), SCN hfac = rt(rt(v) semh);
//             and in the same launch emb @ wxe: xe = rt(v) (6b: xfac =
//             rt(rt(v) semx)).  The LSTM's L1 is h @ [wda | wfb] alone.
//   L2        the attention: kernel 1 (attend.cuh), or kernel 5
//             (attend_q.cuh) on the int8 state (6c), one cluster launch;
//             its weighted sum writes gawe = rt(g rt(awe))
//   L3 small  SCN: gawe @ wxa: xfac = rt(rt(rt(v) + xe) semx)
//   L4 small  the four gates of 64 units in one cluster, the cell in the
//             epilogue: SCN xfac_g @ wxp_g + hfac_g @ whp_g, LSTM
//             [emb | gawe | h] @ [wih ; wh]; pre = rt(v + bx + bh),
//             c' = rt(rt(f c) + rt(i g)), h' = rt(o rt(tanh c'))
//             (SCN gates i, f, o, c; LSTM i, f, g, o)
//   L5 small  logits = rt(rt(h' @ fcw) + fcb) (float32 out)
//   L6 head   per row: max, lse = log sum exp(x - max), K rounds of argmax
//             (step.cuh)
//
// Six launches a step for SCN with attention, five for the LSTM, four for
// 6b (pure_scn: L1, L4, L5, L6); iic_step_launches reports the last call's.
// Every product of the Pallas body runs on the tensor cores; no library
// GEMM is called.  Contract of the head (step_pallas.py:343-370): topv
// holds the max-shifted logits x - max, lse = log sum exp(x - max) in
// float32, so topv - lse is the log-softmax; a round's winner is the
// largest value, ties going to the lowest vocab id.  The vocab is not
// padded, so no padded column exists to win.  No float atomics: every sum
// has one owner and one order.
//
// What bounds it: bytes.  At the flagship widths (D = 512, E = 2048, F4 =
// 2048, V = 6,763) a step reads the weights (13.2 M values, 52.7 MB at
// float32, more than the 50 MB L2) and the encoder state (P (E + A)
// values an image, 64 MB at B = 32 and float32); the products' 3xTF32
// operations at R = 160 are a smaller bound.
//
// What the design does about it: the batch rows are wgmma's N, so a block
// owns one 64-row W tile against the whole beam batch and reads it once,
// by TMA, as stored (no pre-split TF32 copy: the lo part is made in shared
// memory); split-K sums inside a thread-block cluster without a reduce
// launch; every elementwise stage runs in an epilogue (the gates, the
// factors, the cell), so what reaches device memory between launches is a
// few (R, .) rows; the host makes one C call a step on scratch it keeps.
// iic_gemm (mma.cuh, the GEMM of kernel 7) and iic_gemm_ffma stay
// callable for chip_smoke.py and the card tests.
//
// Kernel 13 replaces ops/decode_pallas.py beam_decode_records (body
// _make_kernel): every step of an attention_scn beam decode, with
// per-step selection records -- words and parents (B, T, K) int32, vals
// (B, T, K) float32 -- that decode/replay.py turns into beams.  A step is
// the chain above (the Pallas body rounds at the same points as
// step_pallas.py) and one more launch, seven in all:
//
//   L1        also gathers emb @ wxe's rows from the embedding table by
//             the previous words (int32 ids, read once a block)
//   L6 head   raw: lse = log sum exp(x - max) + max, topv = x - lse
//             (decode_pallas.py:222-235), not kernel 2's shifted form
//   L7 select one block per image (step.cuh select_kernel): the K*K merge,
//             the records, the bookkeeping and the parent reorder of
//             (h, c), in place
//
// An image whose lanes are all dead at the start of a step is frozen
// (act_r, decode_pallas.py:275-293): its state and scores stay, its alive
// count stays 0.  The early exit reads no value on the host: every
// selection ORs "this image is alive" into the step's word live[t + 1]
// (live[0] = 1, the rest 0), and every launch of step t + 1 returns at
// once when live[t + 1] is 0, so the records of a step that did not run
// stay inert (words 0, parents 0, vals NEG).  The TPU kernel exits per
// image chunk; here the exit is for the whole batch.
//
// What bounds kernel 13: T times the step's bound, plus the gather and
// the selection (R * Emb + B * K * K values a step).  What the design
// does about it beyond the step's: the T steps' 1 + 7 T launches are
// captured once into a CUDA graph, keyed by ops/decode_cuda.py on what it
// bakes in, and each decode is one graph launch on the caller's stream,
// so the card does not wait on the host between launches; each decode's
// inputs are copied into the workspace whose addresses the graph holds,
// and the graph's first node resets the beam's state and records.
#include <algorithm>
#include <chrono>
#include <vector>

#include "attend.cuh"
#include "attend_q.cuh"
#include "gemm.cuh"
#include "mma.cuh"
#include "mma_small.cuh"
#include "step.cuh"

// Pointers are device addresses; a null a2 skips the second source and a
// null bias or aux skips that term; a null part runs the product unsplit;
// wt = 1 takes both W stored (N, K), and at float32 w1_lo and w2_lo the
// lo parts of W pre-split into TF32 hi (w1, w2) and lo parts
// (step_cuda.pack_tc).  The tensor-core GEMM takes only that layout; the
// FFMA GEMM takes W (K, N) or, with wt, (N, K), and ignores the lo parts.
// tc = 1: the tensor-core GEMM (mma.cuh, the products of kernels 7 and
// 13); tc = 0: the float32 FFMA GEMM (gemm.cuh), which chip_smoke.py and
// the card tests hold it against.  Returns the launches' CUDA error code.
static int gemm_entry(int tc, int dtype, int epi, int M, int N, int nz,
                      const void* a1, long long lda1, const void* w1,
                      long long ldw1, int k1, const void* a2, long long lda2,
                      const void* w2, long long ldw2, int k2,
                      const void* bias1, const void* bias2, const void* aux,
                      long long ldaux, void* c, long long ldc, int c_f32,
                      long long za, long long zw, long long zc, long long zb,
                      void* part, long long part_cap, const void* w1_lo,
                      const void* w2_lo, int wt, void* stream) {
  iic::GemmArgs g = {};
  g.wt[0] = g.wt[1] = wt;
  g.w_lo[0] = w1_lo; g.w_lo[1] = w2_lo;
  g.a[0] = a1; g.w[0] = w1; g.k[0] = k1; g.lda[0] = lda1; g.ldw[0] = ldw1;
  g.a[1] = a2; g.w[1] = w2; g.k[1] = k2; g.lda[1] = lda2; g.ldw[1] = ldw2;
  g.bias1 = bias1; g.bias2 = bias2; g.aux = aux; g.ldaux = ldaux;
  g.c = c; g.ldc = ldc; g.c_f32 = c_f32;
  g.M = M; g.N = N; g.epi = epi;
  g.za = za; g.zw = zw; g.zc = zc; g.zb = zb;
  g.part = (float*)part; g.part_cap = part_cap;
  if (epi < 0 || epi > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return tc ? iic::launch_gemm_tc<float>(g, nz, s)
              : iic::launch_gemm<float>(g, nz, s);
  if (dtype == iic::kBF16)
    return tc ? iic::launch_gemm_tc<__nv_bfloat16>(g, nz, s)
              : iic::launch_gemm<__nv_bfloat16>(g, nz, s);
  return (int)cudaErrorInvalidValue;
}

#define IIC_GEMM_PARAMS                                                     \
  int dtype, int epi, int M, int N, int nz, const void *a1, long long lda1, \
      const void *w1, long long ldw1, int k1, const void *a2,               \
      long long lda2, const void *w2, long long ldw2, int k2,               \
      const void *bias1, const void *bias2, const void *aux,                \
      long long ldaux, void *c, long long ldc, int c_f32, long long za,     \
      long long zw, long long zc, long long zb, void *part,                 \
      long long part_cap, const void *w1_lo, const void *w2_lo, int wt,     \
      void *stream
#define IIC_GEMM_ARGS                                                       \
  dtype, epi, M, N, nz, a1, lda1, w1, ldw1, k1, a2, lda2, w2, ldw2, k2,     \
      bias1, bias2, aux, ldaux, c, ldc, c_f32, za, zw, zc, zb, part,        \
      part_cap, w1_lo, w2_lo, wt, stream

extern "C" int iic_gemm(IIC_GEMM_PARAMS) {
  return gemm_entry(1, IIC_GEMM_ARGS);
}

extern "C" int iic_gemm_ffma(IIC_GEMM_PARAMS) {
  return gemm_entry(0, IIC_GEMM_ARGS);
}

namespace iic {

// Everything one step needs (unused pointers null).  Every field is 8
// bytes; ops/step_cuda.py mirrors it field for field and checks its size
// against iic_step_args_bytes().  Shapes: enc (B, P, E) and ea (B, P, A)
// in T, or int8 with enc_s, ea_s (B, P) float32 (quant); emb (R, Emb), h,
// c (R, D), semx, semh (R, F4); the packs are step_cuda.step_packs'
// K-major forms (rows ld* values apart), wg's sources starting wg_o1 and
// wg_o2 values in; bxh = bx + bh float32.  The megakernel's steps (SCN
// only) also set: emb_ids (R,) int32, the previous words, with emb the
// embedding table of emb_tab_rows rows (L1 gathers its rows); raw = 1,
// the head's raw form (step.cuh head_topk_kernel); live, the step's
// early-exit word.
struct StepArgs {
  long long R, B, K, P, pa, E, A, D, Emb, F4, V, topk, lstm, quant;
  AttendPlan att;   // ops/attention_cuda.py attend_plan (for pa pixels)
  long long ldw1, ldwxe, ldwxa, ldwg, wg_o1, wg_o2, ldfcw;
  const void *enc, *ea, *enc_s, *ea_s, *emb, *h, *c, *semx, *semh;
  const void *w1, *wxe, *wxa, *wg, *fcw, *bda, *bfb, *wf, *bxh, *fcb;
  void *h_out, *c_out, *topv, *topi, *lse;
  // scratch: dec (R, A), gate (R, E), hfac, xe, xfac (R, F4), gawe (R, E)
  // in T; logits (R, V) float32
  void *s_dec, *s_gate, *s_hfac, *s_xe, *s_xfac, *s_gawe, *s_logits;
  long long raw, emb_tab_rows;
  const void *emb_ids, *live;
};

// Launches of the last iic_step call (or of one captured decode step).
static long long g_step_launches = 0;

#define IIC_TRY(x)              \
  do {                          \
    const int err_ = (x);       \
    if (err_ != 0) return err_; \
  } while (0)

template <typename T, int EPI>
static int step_small(const StepArgs& r, const SmallProb& p0,
                      const SmallProb* p1, cudaStream_t s) {
  SmallLaunch L = {};
  L.p[0] = p0;
  L.nprob = 1;
  if (p1 != nullptr) L.p[L.nprob++] = *p1;
  L.B = (int)r.R;
  L.live = (const int*)r.live;
  ++g_step_launches;
  return launch_small<T, EPI, kSmWide>(L, s);
}

template <typename T>
static int run_step(const StepArgs& r, cudaStream_t s) {
  const int R = r.R, E = r.E, A = r.A, D = r.D, F4 = r.F4, H = D;
  const int F = F4 / 4, lstm = (int)r.lstm;
  const int Hp = (H + kSmM - 1) / kSmM * kSmM;   // a gate pack's units
  const bool att = r.enc != nullptr;
  g_step_launches = 0;
  // L1: the products of h (and, SCN, of emb)
  const int nh = (att ? A + E : 0) + (lstm ? 0 : F4);
  SmallProb ph = small_prob(nh, kSmStepIn);
  small_src(ph, r.h, D, r.w1, r.ldw1, nh, D);
  ph.n1 = att ? A : 0, ph.n2 = att ? A + E : 0;
  ph.bias1 = r.bda, ph.bias2 = r.bfb;
  ph.out = r.s_dec, ph.ldo = A;
  ph.out2 = r.s_gate, ph.ldo2 = E;
  ph.aux = r.semh, ph.ldaux = F4;
  ph.out3 = r.s_hfac, ph.ldo3 = F4;
  if (lstm) {
    IIC_TRY((step_small<T, kSmStepIn>(r, ph, nullptr, s)));
  } else {
    SmallProb pe = small_prob(F4, kSmStepIn);
    small_src(pe, r.emb, r.Emb, r.wxe, r.ldwxe, F4, (int)r.Emb);
    pe.aux = att ? nullptr : r.semx, pe.ldaux = F4;
    pe.out3 = att ? r.s_xe : r.s_xfac, pe.ldo3 = F4;
    if (r.emb_ids == nullptr) {
      IIC_TRY((step_small<T, kSmStepIn>(r, ph, &pe, s)));
    } else {     // the megakernel: emb's rows gathered by the previous words
      ph.epi = pe.epi = kSmStepGather;
      pe.xid = (const int*)r.emb_ids, pe.xid_rows = (int)r.emb_tab_rows;
      IIC_TRY((step_small<T, kSmStepGather>(r, ph, &pe, s)));
    }
  }
  // L2: the attention, gated in its weighted sum
  if (att) {
    ++g_step_launches;
    if (r.quant)
      IIC_TRY(launch_attend_q<T>(r.enc, r.enc_s, r.ea, r.ea_s, r.s_dec, r.wf,
                                 r.s_gawe, nullptr, r.B, r.K, r.P, r.pa, E,
                                 A, r.att, s, r.s_gate));
    else
      IIC_TRY(launch_attend<T>(r.enc, r.ea, r.s_dec, r.wf, r.s_gawe, nullptr,
                               r.B, r.K, r.P, E, A, r.att, s,
                               (const int*)r.live, r.s_gate));
  }
  // L3: SCN's xfac from the attention
  if (att && !lstm) {
    SmallProb p = small_prob(F4, kSmXfac);
    small_src(p, r.s_gawe, E, r.wxa, r.ldwxa, F4, E);
    p.aux = r.s_xe, p.ldaux = F4;
    p.aux2 = r.semx, p.ldaux2 = F4;
    p.out = r.s_xfac, p.ldo = F4;
    IIC_TRY((step_small<T, kSmXfac>(r, p, nullptr, s)));
  }
  // L4: the gates, the cell in the epilogue
  SmallProb pc = small_prob(H, kSmStepCell);
  gates_interleaved(pc);
  if (lstm) {
    const T* wg = (const T*)r.wg;
    small_src(pc, r.emb, r.Emb, wg, r.ldwg, 4 * Hp, (int)r.Emb);
    small_src(pc, r.s_gawe, E, wg + r.wg_o1, r.ldwg, 4 * Hp, E);
    small_src(pc, r.h, D, wg + r.wg_o2, r.ldwg, 4 * Hp, D);
  } else {
    pc.zx = F;
    small_src(pc, r.s_xfac, F4, r.wg, r.ldwg, 4 * Hp, F);
    small_src(pc, r.s_hfac, F4, (const T*)r.wg + r.wg_o1, r.ldwg, 4 * Hp, F);
  }
  pc.lstm = lstm;
  pc.bias1 = r.bxh;
  pc.aux3 = r.c, pc.ldaux3 = D;
  pc.out = r.h_out, pc.ldo = D;
  pc.out2 = r.c_out, pc.ldo2 = D;
  IIC_TRY((step_small<T, kSmStepCell>(r, pc, nullptr, s)));
  // L5: the logits; L6: the head
  SmallProb pl = small_prob((int)r.V, kSmLogits);
  small_src(pl, r.h_out, D, r.fcw, r.ldfcw, r.V, D);
  pl.bias1 = r.fcb;
  pl.out = r.s_logits, pl.ldo = r.V;
  IIC_TRY((step_small<T, kSmLogits>(r, pl, nullptr, s)));
  ++g_step_launches;
  return launch_head(r.s_logits, R, (int)r.V, (int)r.topk, r.topv, r.topi,
                     r.lse, (int)r.raw, s, (const int*)r.live);
}

static bool step_valid(const StepArgs& r) {
  const bool att = r.enc != nullptr;
  if (r.emb_ids != nullptr && (r.lstm || r.emb_tab_rows < 1)) return false;
  return r.R >= 1 && r.D >= 1 && r.V >= 1 && r.topk >= 1 && r.topk <= r.V &&
         (r.lstm ? att : r.F4 % 4 == 0 && r.F4 >= 4) &&
         (!att || (r.B >= 1 && r.K >= 1 && r.R == r.B * r.K &&
                   (!r.quant || (r.pa >= 1 && r.pa <= r.P))));
}

// ------------------------------------------------------- kernel 13 ----

// A whole decode (the megakernel): one step's arguments, whose emb is the
// embedding table, h and c the carried state, h_out, c_out, topv, topi
// and lse scratch; and the beam's state and records.  Every field is 8
// bytes; ops/decode_cuda.py mirrors it and checks its size against
// iic_decode_args_bytes().
struct DecodeArgs {
  StepArgs step;
  long long steps, start_id, end_id;   // T, <start>, <end>
  void *sc, *pw, *alive;          // (R,) float32, (R,) and (B,) int32
  void *words, *parents, *vals;   // (B, T, K) int32, int32, float32
  void* live;                     // (T + 1,) int32
};

// The decode's first node: beam.init_carry's state (lane 0 of each image
// holds <start> at score 0, the other lanes are dead, K lanes alive), the
// records inert (words 0, parents 0, vals NEG) and the early-exit words
// 1, 0, ..., 0 -- so a replay of the graph starts from nothing a past
// decode left.
__global__ void decode_init_kernel(float* sc, int* pw, int* alive,
                                   int* words, int* parents, float* vals,
                                   int* live, int B, int K, int T,
                                   int start_id, long long n) {
  const long long nrec = (long long)B * T * K;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < nrec) {
      words[i] = 0;
      parents[i] = 0;
      vals[i] = kNeg;
    }
    if (i < B * K) {
      sc[i] = i % K == 0 ? 0.0f : kNeg;
      pw[i] = start_id;
    }
    if (i < B) alive[i] = K;
    if (i <= T) live[i] = i == 0;
  }
}

// Launches of one step of the last captured decode, graphs captured and
// graph launches.
static long long g_decode_step_launches = 0, g_captures = 0,
                 g_graph_launches = 0;

// The decode's launch sequence on stream s: the start, then T times the
// step chain (run_step, raw head, early exit) and the selection.
template <typename T>
static int run_decode(const DecodeArgs& d, cudaStream_t s) {
  const StepArgs& r0 = d.step;
  const int B = (int)r0.B, K = (int)r0.K, TT = (int)d.steps;
  const long long n = std::max((long long)B * TT * K,
                               (long long)std::max(B * K, TT + 1));
  decode_init_kernel<<<(int)std::min((n + 255) / 256, 1024LL), 256, 0, s>>>(
      (float*)d.sc, (int*)d.pw, (int*)d.alive, (int*)d.words,
      (int*)d.parents, (float*)d.vals, (int*)d.live, B, K, TT,
      (int)d.start_id, n);
  IIC_TRY((int)cudaGetLastError());
  for (int t = 0; t < TT; ++t) {
    StepArgs r = r0;
    r.emb_ids = d.pw;
    r.raw = 1;
    r.live = (const int*)d.live + t;
    IIC_TRY(run_step<T>(r, s));
    SelectArgs a = {};
    a.topv = (const float*)r.topv;   // log-probabilities (the raw head)
    a.topi = (const int*)r.topi;
    a.lse = nullptr;
    a.sc_in = (const float*)d.sc;
    a.pw_in = (const int*)d.pw;
    a.alive_in = (const int*)d.alive;
    a.sc = (float*)d.sc;
    a.pw = (int*)d.pw;
    a.alive = (int*)d.alive;
    a.h_new = r.h_out;
    a.c_new = r.c_out;
    a.h_src = r.h;
    a.c_src = r.c;
    a.h = (void*)r.h;
    a.c = (void*)r.c;
    a.words = (int*)d.words;
    a.parents = (int*)d.parents;
    a.vals = (float*)d.vals;
    a.K = K;
    a.D = (int)r.D;
    a.end_id = (int)d.end_id;
    a.freeze = 1;
    a.step = t;
    a.rec_steps = TT;
    a.live_in = (const int*)d.live + t;
    a.live_out = (int*)d.live + t + 1;
    select_kernel<T><<<B, kSelectThreads, 0, s>>>(a);
    IIC_TRY((int)cudaGetLastError());
    if (t == 0) g_decode_step_launches = g_step_launches + 1;
  }
  return 0;
}

static bool decode_valid(const DecodeArgs& d) {
  const StepArgs& r = d.step;
  return r.enc != nullptr && !r.lstm && !r.quant && r.topk == r.K &&
         r.emb_tab_rows >= 1 && d.steps >= 1 && d.start_id >= 0 &&
         d.start_id < r.emb_tab_rows && step_valid(r);
}

// A captured decode: the graph (kept for its node handles) and its
// executable form.
struct DecodeGraph {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
};

// The stream the decodes are captured on.  PyTorch's default stream is the
// legacy one, which cannot be captured; a graph replays on any stream.
static int capture_stream(cudaStream_t* s) {
  static cudaStream_t cs = nullptr;
  if (cs == nullptr) {
    const int err = (int)cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
    if (err != 0) {
      cs = nullptr;
      return err;
    }
  }
  *s = cs;
  return 0;
}

}  // namespace iic

extern "C" int iic_step_args_bytes() { return (int)sizeof(iic::StepArgs); }

extern "C" int iic_decode_args_bytes() {
  return (int)sizeof(iic::DecodeArgs);
}

// Kernel 13: captures the whole decode's launch sequence (the start, then
// T steps of seven launches) into a CUDA graph and instantiates it; the
// handle receives it.  The graph bakes in every address of args: the
// caller keeps them alive and writes each decode's inputs into them.
// Relaxed capture: the launchers' first calls set function attributes and
// query the card while capturing.  Returns a CUDA error code.
extern "C" int iic_decode_capture(int dtype, const void* args,
                                  void** handle) {
  const iic::DecodeArgs& d = *(const iic::DecodeArgs*)args;
  if (!iic::decode_valid(d) || (dtype != iic::kF32 && dtype != iic::kBF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs;
  int rc = iic::capture_stream(&cs);
  if (rc != 0) return rc;
  rc = (int)cudaStreamBeginCapture(cs, cudaStreamCaptureModeRelaxed);
  if (rc != 0) return rc;
  rc = dtype == iic::kF32 ? iic::run_decode<float>(d, cs)
                          : iic::run_decode<__nv_bfloat16>(d, cs);
  cudaGraph_t g = nullptr;
  const int end = (int)cudaStreamEndCapture(cs, &g);
  if (rc == 0) rc = end;
  cudaGraphExec_t e = nullptr;
  if (rc == 0) rc = (int)cudaGraphInstantiate(&e, g, 0);
  if (rc != 0) {
    if (g != nullptr) cudaGraphDestroy(g);
    cudaGetLastError();
    return rc;
  }
  *handle = new iic::DecodeGraph{g, e};
  ++iic::g_captures;
  return 0;
}

// One decode: the captured graph, launched on the stream.
extern "C" int iic_decode_launch(void* handle, void* stream) {
  const auto* h = (const iic::DecodeGraph*)handle;
  const int rc = (int)cudaGraphLaunch(h->exec, (cudaStream_t)stream);
  if (rc == 0) ++iic::g_graph_launches;
  return rc;
}

// Frees a captured decode (a replay in flight finishes first).
extern "C" int iic_decode_release(void* handle) {
  auto* h = (iic::DecodeGraph*)handle;
  int rc = (int)cudaGraphExecDestroy(h->exec);
  const int rc2 = (int)cudaGraphDestroy(h->graph);
  delete h;
  return rc != 0 ? rc : rc2;
}

// Launches of one step of the last captured decode.
extern "C" int iic_decode_step_launches() {
  return (int)iic::g_decode_step_launches;
}

// Decodes captured, and graph launches, since the library was loaded.
extern "C" int iic_decode_captures() { return (int)iic::g_captures; }
extern "C" int iic_decode_graph_launches() {
  return (int)iic::g_graph_launches;
}

// What the other way to feed a graph its inputs would cost: every kernel
// node's parameters set again (to their own values) on the executable
// graph, on the host clock.  nodes receives the kernel nodes, ms the
// milliseconds.  For chip_smoke.py; the decode copies its inputs instead.
extern "C" int iic_decode_update_probe(void* handle, int* nodes, double* ms) {
  const auto* h = (const iic::DecodeGraph*)handle;
  size_t n = 0;
  int rc = (int)cudaGraphGetNodes(h->graph, nullptr, &n);
  if (rc != 0) return rc;
  std::vector<cudaGraphNode_t> all(n);
  rc = (int)cudaGraphGetNodes(h->graph, all.data(), &n);
  if (rc != 0) return rc;
  const auto t0 = std::chrono::steady_clock::now();
  int k = 0;
  for (cudaGraphNode_t node : all) {
    cudaGraphNodeType ty;
    rc = (int)cudaGraphNodeGetType(node, &ty);
    if (rc != 0) return rc;
    if (ty != cudaGraphNodeTypeKernel) continue;
    cudaKernelNodeParams p;
    rc = (int)cudaGraphKernelNodeGetParams(node, &p);
    if (rc == 0) rc = (int)cudaGraphExecKernelNodeSetParams(h->exec, node, &p);
    if (rc != 0) return rc;
    ++k;
  }
  *ms = std::chrono::duration<double, std::milli>(
            std::chrono::steady_clock::now() - t0).count();
  *nodes = k;
  return 0;
}

// Kernel launches of the last iic_step call.
extern "C" int iic_step_launches() { return (int)iic::g_step_launches; }

// One fused decode step (kernels 2, 6b, 6c), every launch of its chain on
// the stream.  Returns the first failing launch's CUDA error code, 0 on
// success.
extern "C" int iic_step(int dtype, const void* args, void* stream) {
  const iic::StepArgs& r = *(const iic::StepArgs*)args;
  if (!iic::step_valid(r)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32) return iic::run_step<float>(r, s);
  if (dtype == iic::kBF16) return iic::run_step<__nv_bfloat16>(r, s);
  return (int)cudaErrorInvalidValue;
}

// The chain's GEMM alone at the wide batch tile, for the card tests and
// chip_smoke.py: out (B, N) float32 = x (B, K) @ w (N, K)^T, w K-major.
extern "C" int iic_wide_gemm(int dtype, const void* x, long long ldx,
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
    return iic::launch_small<float, iic::kSmPlain, iic::kSmWide>(L, s);
  if (dtype == iic::kBF16)
    return iic::launch_small<__nv_bfloat16, iic::kSmPlain, iic::kSmWide>(L,
                                                                         s);
  return (int)cudaErrorInvalidValue;
}
