// Kernel 5: one additive-attention step over int8 encoder state, for K
// beam lanes of each image -- the C entry point.  The kernel, what bounds
// it and what its design does about it are in attend_q.cuh and
// attend.cuh, which step.cu shares.
#include "attend_q.cuh"

// enc_q (B, P, E) and ea_q (B, P, A) int8; enc_s and ea_s (B, P) float32;
// dec (B, K, A), awe (B, K, E) and alpha (B, K, pa; may be null) in the
// dtype's storage; wf (A,) float32; plan from ops/attention_cuda.py
// attend_plan for pa pixels at int8.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int iic_attend_q(int dtype, const void* enc_q, const void* enc_s,
                            const void* ea_q, const void* ea_s,
                            const void* dec, const void* wf, void* awe,
                            void* alpha, int B, int K, int P, int pa, int E,
                            int A, const void* plan, void* stream) {
  const iic::AttendPlan& pl = *(const iic::AttendPlan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::launch_attend_q<float>(enc_q, enc_s, ea_q, ea_s, dec, wf,
                                       awe, alpha, B, K, P, pa, E, A, pl, s);
  if (dtype == iic::kBF16)
    return iic::launch_attend_q<__nv_bfloat16>(enc_q, enc_s, ea_q, ea_s, dec,
                                               wf, awe, alpha, B, K, P, pa,
                                               E, A, pl, s);
  return (int)cudaErrorInvalidValue;
}
