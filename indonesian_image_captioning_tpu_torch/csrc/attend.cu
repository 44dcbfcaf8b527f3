// Kernel 1: one additive-attention step for K beam lanes of each image --
// the C entry point.  The kernel, what bounds it and what its design does
// about it are in attend.cuh, which span.cu and step.cu share.
#include "attend.cuh"

// enc (B, P, E), ea (B, P, A), dec (B, K, A), awe (B, K, E) and alpha
// (B, K, P; may be null) in the dtype's storage; wf (A,) float32; plan
// from ops/attention_cuda.py attend_plan.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int iic_attend(int dtype, const void* enc, const void* ea,
                          const void* dec, const void* wf, void* awe,
                          void* alpha, int B, int K, int P, int E, int A,
                          const void* plan, void* stream) {
  const iic::AttendPlan& pl = *(const iic::AttendPlan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::launch_attend<float>(enc, ea, dec, wf, awe, alpha, B, K, P,
                                     E, A, pl, s);
  if (dtype == iic::kBF16)
    return iic::launch_attend<__nv_bfloat16>(enc, ea, dec, wf, awe, alpha,
                                             B, K, P, E, A, pl, s);
  return (int)cudaErrorInvalidValue;
}
