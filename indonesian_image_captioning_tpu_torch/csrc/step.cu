// Kernel 2: the C entry points of one fused beam-decode step over R = B*K
// rows.
//
// Replaces indonesian_image_captioning_tpu/ops/step_pallas.py
// fused_decode_step and fused_decode_step_noattn (body _make_kernel, call
// _fused_call).  The Pallas body is one kernel; here the step is a short
// chain of launches of the GEMM (mma.cuh), the cell and head kernels
// (step.cuh, shared with span.cu) and kernel 1 (attend.cu), driven by
// ops/step_cuda.py:
//
//   gemm  dec  = h @ wda + bda                                 (attention)
//   attend awe = attention(enc, ea, dec)                 kernel 1 (attention)
//   gemm  gawe = sigmoid(h @ wfb + bfb) * awe                  (attention)
//   SCN:  gemm xfac = ([emb | gawe] @ [wxe ; wxa]) * semx
//         gemm hfac = (h @ wh) * semh
//         gemm pre[g] = xfac[g] @ wxp[g] + hfac[g] @ whp[g] + bx[g] + bh[g],
//              the four gates as gridDim.z
//   LSTM: gemm pre = [emb | gawe] @ wih + h @ wh + bx + bh
//   cell  c' = f*c + i*g;  h' = o*tanh(c')    (SCN gates i,f,o,c; LSTM i,f,g,o)
//   gemm  logits = h' @ fcw + fcb   (float32 out)
//   head  per row: max, lse = log sum exp(x - max), K rounds of argmax
//
// Every product of the Pallas body (wda, wfb, wxe/wxa, wh, wxp/whp, wih,
// fcw) runs in the tensor-core GEMM of mma.cuh (iic_gemm, on weights
// packed by step_cuda.pack_tc; gemm.cuh's FFMA GEMM stays callable as
// iic_gemm_ffma); no library GEMM is called.  Contract of the head (step_pallas.py:343-370): topv holds the max-shifted logits x - max,
// lse = log sum exp(x - max) in float32, so topv - lse is the log-softmax;
// a round's winner is the largest value, ties going to the lowest vocab id,
// and each winner is masked with -1e30 before the next round.  The vocab is
// not padded, so no padded column exists to win.
//
// What bounds it: at R = 640 rows (B = 128, K = 5) the step reads the
// 512 x 6763 head weight (13.8 MB at float32) and does 4.4 GFLOP in the head
// GEMM, and the attention reads the encoder state (2 MB per image).  The
// cell GEMMs are about half the head's flops.  So the head GEMM is the
// largest arithmetic term and the encoder read the largest byte term.
//
// What the design does about it: the GEMM (mma.cuh) tiles 64 x 64
// outputs per warpgroup on the tensor cores, K tiles in a ring that a
// producer warpgroup fills by cp.async (a weight column is read once per
// row tile, not once per row), and splits K where the output tiles do not
// fill the card; the
// elementwise work (bias, sigmoid gate, semantic modulation) is fused into
// the GEMM epilogues so no pre-activation makes a round trip except the
// gate pre-activations and the logits; the head reads each logit row from
// L2 for its K + 2 passes.  TMA and a head that never writes the logits
// are later work.
#include "gemm.cuh"
#include "mma.cuh"
#include "step.cuh"

// Pointers are device addresses; a null a2 skips the second source and a
// null bias or aux skips that term; a null part runs the product unsplit;
// wt = 1 takes both W stored (N, K), and at float32 w1_lo and w2_lo the
// lo parts of W pre-split into TF32 hi (w1, w2) and lo parts
// (step_cuda.pack_tc).  The tensor-core GEMM takes only that layout; the
// FFMA GEMM takes W (K, N) or, with wt, (N, K), and ignores the lo parts.
// tc = 1: the tensor-core GEMM (mma.cuh, the chain's); tc = 0: the float32
// FFMA GEMM (gemm.cuh), which chip_smoke.py and the card tests hold it
// against.  Returns the launches' CUDA error code.
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

extern "C" int iic_cell(int dtype, int lstm, const void* pre, const void* c,
                        void* h_out, void* c_out, int R, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::launch_cell<float>(pre, c, h_out, c_out, R, H, lstm, s);
  if (dtype == iic::kBF16)
    return iic::launch_cell<__nv_bfloat16>(pre, c, h_out, c_out, R, H, lstm,
                                           s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int iic_head_topk(const void* logits, int R, int V, int K,
                             void* topv, void* topi, void* lse, void* stream) {
  return iic::launch_head(logits, R, V, K, topv, topi, lse, 0,
                          (cudaStream_t)stream);
}
