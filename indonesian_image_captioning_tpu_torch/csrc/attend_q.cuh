// Kernel 5's device code: one additive-attention step over int8 encoder
// state, for K beam lanes of each image, shared by attend_q.cu (its C
// entry point) and step.cu (kernel 6c's chain).
//
// Replaces indonesian_image_captioning_tpu/ops/attention_pallas.py
// attend_fused_q (body _make_kernel_q), and the attention stage of
// ops/step_pallas.py fused_decode_step_q (kernel 6c, whose chain in
// step.cu launches this kernel).  The encoder state is stored as
// symmetric int8 with one float32 scale per (image, pixel)
// (quantize_pixels: x ~= q * s):
//
//   ea[p]     = rt(q_ea[p] * rt(s_ea[p]))           (dequantised in T)
//   att[k, p] = rt(sum_a rt(relu(rt(ea[p, a] + dec[k, a])) * rt(wf[a])))
//   alpha[k]  = softmax over p < p_actual of att[k]  (float32)
//   awe[k]    = rt(sum_p rt(alpha[k, p] * s_enc[p]) * q_enc[p])
//
// rt() rounds through the working type T (float32 or bfloat16) where the
// Pallas body casts: the dequantised ea, the relu argument, each product
// with wf and their sum (attend_quant_ref: "products in dt, lane-sum,
// then f32"); the enc scale is folded into alpha in float32 and the
// product rounded to T before the weighted sum, which accumulates in
// float32 against the exact int8 values.  Pixels at and past p_actual take
// no part (alpha 0): the softmax runs over the first p_actual pixels only,
// so no -inf enters the arithmetic.  The Mosaic padding of P to a multiple
// of 32, the block-diagonal one-hot scratch and the image groups of the
// TPU kernel are not carried over.
//
// What bounds it: reading the encoder state once, P * (E + A) bytes per
// image (196 * 2,560 = 0.5 MB at the flagship widths, a quarter of kernel
// 1's float32 bytes) plus 8 bytes of scales per pixel, against about
// K * P * (3A + 2E) flops: under two flops per byte at K = 5, so memory.
//
// What the design does about it: kernel 1's (attend.cuh), one launch and
// one cluster per image, instantiated on int8 storage: the ea rows staged
// by 16-byte copies of 16 values, the scores exchanged through distributed
// shared memory, the enc scales folded into alpha in each rank's table,
// and the weighted sum from a ring of enc rows filled by 16-byte copies,
// a thread summing four columns of eight lanes.  The int8 values become
// floats by a byte permute and one add, not by the quarter-rate I2F
// conversion.
#pragma once

#include "attend.cuh"

namespace iic {

// Kernel 5: enc_q (B, P, E) and ea_q (B, P, A) int8, enc_s and ea_s (B, P)
// float32, dec (B, K, A) in T, wf (A,) float32; awe (B, K, E) and alpha
// (B, K, pa; may be null) in T; plan made for pa pixels.  With a gate (B,
// K, E) awe receives rt(gate rt(awe)).  Returns the CUDA error code.
template <typename T>
static int launch_attend_q(const void* enc_q, const void* enc_s,
                           const void* ea_q, const void* ea_s,
                           const void* dec, const void* wf, void* awe,
                           void* alpha, int B, int K, int P, int pa, int E,
                           int A, const AttendPlan& plan,
                           cudaStream_t stream, const void* gate = nullptr) {
  AttendJob J = {};
  J.enc = enc_q, J.ea = ea_q, J.dec = dec, J.wf = (const float*)wf;
  J.enc_s = (const float*)enc_s, J.ea_s = (const float*)ea_s;
  J.awe = awe, J.alpha = alpha, J.gate = gate;
  J.K = K, J.P = P, J.pa = pa, J.E = E, J.A = A;
  return gate ? launch_attend_cluster<T, int8_t, true>(J, plan, B, stream)
              : launch_attend_cluster<T, int8_t, false>(J, plan, B, stream);
}

}  // namespace iic
