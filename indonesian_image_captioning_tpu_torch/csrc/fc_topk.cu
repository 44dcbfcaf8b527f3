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
// and a sorted top-k.  Here the vocab is not padded (the wrapper takes
// k <= V, where no padded column could win a slot or add to the sum), and
// the call is a chain of two launches: the shared GEMM (gemm.cuh, 64 x 64
// tiles, bias in the epilogue) writes the (R, V) float32 logits to a
// scratch buffer, and step.cuh's head kernel (raw mode 2: K rounds of
// max with the lowest id on ties, each winner masked before the next)
// reads each row from L2 for its max, its sum and its k rounds.
//
// What bounds it: at R = 160 rows (B = 32, K = 5) and V = 6,763 the
// product is 2 R D V = 1.11 GFLOP against 13.9 MB of weights: arithmetic
// (0.017 ms at 67 TFLOP/s float32) over bytes (0.004 ms).  What the
// design does about it, in this first version: the GEMM reads each weight
// column once per 64-row block; the logits' round trip (4.3 MB) stays in
// the 50 MB L2.  Tensor cores (3xTF32) and a head folded into the GEMM's
// epilogue, as the Pallas kernel does, are later work.
#include "gemm.cuh"
#include "step.cuh"

// h (R, D), w (D, V), b (V,), the scratch logits (R, V), topv (R, k) and
// lse (R,) float32; topi (R, k) int32.  Returns the CUDA error code of the
// launches (0 on success).
extern "C" int iic_fc_topk(const void* h, const void* w, const void* b,
                           void* logits, void* topv, void* topi, void* lse,
                           int R, int D, int V, int k, void* stream) {
  if (R < 1 || D < 1 || k < 1 || k > V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  iic::GemmArgs g = {};
  g.a[0] = h; g.w[0] = w; g.k[0] = D; g.lda[0] = D; g.ldw[0] = V;
  g.bias1 = b;
  g.c = logits; g.ldc = V; g.c_f32 = 1;
  g.M = R; g.N = V; g.epi = iic::kEpiBias;
  const int err = iic::launch_gemm<float>(g, 1, s);
  if (err != 0) return err;
  return iic::launch_head(logits, R, V, k, topv, topi, lse, 2, s);
}
