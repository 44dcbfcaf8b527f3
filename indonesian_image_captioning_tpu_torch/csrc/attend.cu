// Kernel 1: one additive-attention step for K beam lanes of each image --
// the C entry point.  The kernels, what bounds them and what their design
// does about it are in attend.cuh, which span.cu shares.
#include "attend.cuh"

// enc (B, P, E), ea (B, P, A), dec (B, K, A), awe (B, K, E) and alpha
// (B, K, P; may be null) in the dtype's storage; wf (A,) and the scratch
// scores (B, K, P) float32.  Returns the CUDA error code of the launches
// (0 on success).
extern "C" int iic_attend(int dtype, const void* enc, const void* ea,
                          const void* dec, const void* wf, void* scores,
                          void* awe, void* alpha, int B, int K, int P, int E,
                          int A, int esplit, void* stream) {
  if (K < 1 || esplit < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::launch_attend<float>(enc, ea, dec, wf, scores, awe, alpha, B,
                                     K, P, E, A, esplit, s);
  if (dtype == iic::kBF16)
    return iic::launch_attend<__nv_bfloat16>(enc, ea, dec, wf, scores, awe,
                                             alpha, B, K, P, E, A, esplit, s);
  return (int)cudaErrorInvalidValue;
}
