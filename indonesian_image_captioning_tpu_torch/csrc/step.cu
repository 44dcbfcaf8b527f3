// Kernel 2: the C entry points of one fused beam-decode step over R = B*K
// rows.
//
// Replaces indonesian_image_captioning_tpu/ops/step_pallas.py
// fused_decode_step and fused_decode_step_noattn (body _make_kernel, call
// _fused_call).  The Pallas body is one kernel; here the step is a short
// chain of launches of the GEMM (gemm.cuh), the cell and head kernels
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
// fcw) runs in gemm_kernel; no library GEMM is called.  Contract of the
// head (step_pallas.py:343-370): topv holds the max-shifted logits x - max,
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
// What the design does about it, in this first version: the GEMM
// (gemm.cuh, shared with train.cu) tiles 64 x 64 outputs per block with
// 16-deep float32 tiles in shared memory (a weight column is read once per
// 64-row block, not once per row); the elementwise work (bias, sigmoid
// gate, semantic modulation) is fused into the GEMM epilogues so no
// pre-activation makes a round trip except the gate pre-activations and
// the logits; the head reads each logit row from
// L2 for its K + 2 passes.  Tensor-core (wgmma) tiles, TMA and a head that
// never writes the logits are later work.
#include "gemm.cuh"
#include "step.cuh"

// Pointers are device addresses; a null a2 skips the second source and a
// null bias or aux skips that term.  Returns the launch's CUDA error code.
extern "C" int iic_gemm(int dtype, int epi, int M, int N, int nz,
                        const void* a1, long long lda1, const void* w1,
                        long long ldw1, int k1, const void* a2,
                        long long lda2, const void* w2, long long ldw2, int k2,
                        const void* bias1, const void* bias2, const void* aux,
                        long long ldaux, void* c, long long ldc, int c_f32,
                        long long za, long long zw, long long zc,
                        long long zb, void* stream) {
  iic::GemmArgs g = {};
  g.a[0] = a1; g.w[0] = w1; g.k[0] = k1; g.lda[0] = lda1; g.ldw[0] = ldw1;
  g.a[1] = a2; g.w[1] = w2; g.k[1] = k2; g.lda[1] = lda2; g.ldw[1] = ldw2;
  g.bias1 = bias1; g.bias2 = bias2; g.aux = aux; g.ldaux = ldaux;
  g.c = c; g.ldc = ldc; g.c_f32 = c_f32;
  g.M = M; g.N = N; g.epi = epi;
  g.za = za; g.zw = zw; g.zc = zc; g.zb = zb;
  if (epi < 0 || epi > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32) return iic::launch_gemm<float>(g, nz, s);
  if (dtype == iic::kBF16) return iic::launch_gemm<__nv_bfloat16>(g, nz, s);
  return (int)cudaErrorInvalidValue;
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
