// Kernel 5: one additive-attention step over int8 encoder state, for K
// beam lanes of each image.
//
// Replaces indonesian_image_captioning_tpu/ops/attention_pallas.py
// attend_fused_q (body _make_kernel_q), and the attention stage of
// ops/step_pallas.py fused_decode_step_q (kernel 6c, which
// ops/step_cuda.py chains from this entry point).  The encoder state is
// stored as symmetric int8 with one float32 scale per (image, pixel)
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
// float32.  Pixels at and past p_actual take no part (alpha 0): the
// softmax runs over the first p_actual pixels only, so no -inf enters
// the arithmetic.  The Mosaic padding of P to a multiple of 32, the
// block-diagonal one-hot scratch and the image groups of the TPU kernel
// are not carried over.
//
// What bounds it: reading the encoder state, P * (E + A) bytes per image
// (196 * 2560 = 0.5 MB at the flagship dims, a quarter of kernel 1's
// float32 bytes) plus 8 bytes of scales per pixel, against about
// K * P * (3A + 2E) flops: under two flops per byte, so memory, and at
// this size the latency of the loads rather than the bus.
//
// What the design does about it: kernel 1's two launches (attend.cuh)
// with int8 loads.  The first reads ea_q once for all K lanes, one warp
// per pixel, and writes the (B, K, p_actual) float32 score table; the
// second takes one image's scores into shared memory, runs the softmax,
// folds the enc scales into alpha there, and has one thread per enc
// column keep K sums with eight pixel rows of loads in flight.  Both
// grids carry enough blocks to fill the 132 SMs at B = 32.  Any K: as in
// kernel 1, a beam wider than the eight-lane register body runs as
// ceil(K / 8) lane groups, the grid's z dimension in both launches.
#include <cstdint>

#include "common.cuh"

namespace iic {

constexpr int kAttendQThreads = 256;

// Grid (B, ceil(p_actual / warps per block), lane groups); the block's
// lanes are k0 .. k0 + kg - 1 (k0 = 8 * blockIdx.z); scores (B, K,
// p_actual).
template <typename T>
__global__ void __launch_bounds__(kAttendQThreads)
attend_q_scores_kernel(const int8_t* __restrict__ ea_q,
                       const float* __restrict__ ea_s,
                       const T* __restrict__ dec, const float* __restrict__ wf,
                       float* __restrict__ scores, int K, int P, int pa,
                       int A) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.z * kLaneGroup;
  const int kg = min(kLaneGroup, K - k0);
  float* dec_s = smem;           // kg * A
  float* wf_s = dec_s + kg * A;  // A
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = blockIdx.y * (blockDim.x >> 5) + (tid >> 5);

  for (int i = tid; i < kg * A; i += blockDim.x)
    dec_s[i] = to_f(dec[((size_t)b * K + k0) * A + i]);
  for (int i = tid; i < A; i += blockDim.x) wf_s[i] = rt<T>(wf[i]);
  __syncthreads();
  if (p >= pa) return;

  const float s = rt<T>(ea_s[(size_t)b * P + p]);
  float acc[kLaneGroup];
#pragma unroll
  for (int k = 0; k < kLaneGroup; ++k) acc[k] = 0.0f;
  const int8_t* row = ea_q + ((size_t)b * P + p) * A;
#pragma unroll 4
  for (int a = lane; a < A; a += 32) {
    const float x = rt<T>((float)row[a] * s);
    const float w = wf_s[a];
#pragma unroll
    for (int k = 0; k < kLaneGroup; ++k) {
      if (k < kg) {
        const float e = fmaxf(rt<T>(x + dec_s[k * A + a]), 0.0f);
        acc[k] += rt<T>(e * w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kLaneGroup; ++k) {
    if (k < kg) {
      const float v = warp_sum(acc[k]);
      if (lane == 0) scores[((size_t)b * K + k0 + k) * pa + p] = rt<T>(v);
    }
  }
}

// Softmax over the first pa pixels, the enc scale folded into alpha, then
// the weighted sum over this block's columns, for lane group blockIdx.z.
// Grid (B, esplit, lane groups); every block of an image recomputes its
// lanes' tiny kg x pa softmax, and block y == 0 writes their alpha (B, K,
// pa) when asked for.
template <typename T>
__global__ void __launch_bounds__(kAttendQThreads)
attend_q_sum_kernel(const int8_t* __restrict__ enc_q,
                    const float* __restrict__ enc_s,
                    const float* __restrict__ scores, T* __restrict__ awe,
                    T* __restrict__ alpha, int K, int P, int pa, int E,
                    int e_chunk) {
  extern __shared__ float smem[];
  float* att = smem;            // kg * pa: scores, then rt(alpha * s_enc)
  const int k0 = blockIdx.z * kLaneGroup;
  const int kg = min(kLaneGroup, K - k0);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int8_t* enc_b = enc_q + (size_t)b * P * E;
  const float* s_b = enc_s + (size_t)b * P;

  for (int i = tid; i < kg * pa; i += blockDim.x)
    att[i] = scores[((size_t)b * K + k0) * pa + i];
  __syncthreads();

  for (int k = warp; k < kg; k += nwarps) {
    float* a_k = att + k * pa;
    float m = -INFINITY;
    for (int p = lane; p < pa; p += 32) m = fmaxf(m, a_k[p]);
    m = warp_max(m);
    float s = 0.0f;
    for (int p = lane; p < pa; p += 32) s += expf(a_k[p] - m);
    s = warp_sum(s);
    for (int p = lane; p < pa; p += 32) {
      const float v = expf(a_k[p] - m) / s;
      if (alpha != nullptr && blockIdx.y == 0)
        alpha[((size_t)b * K + k0 + k) * pa + p] = from_f<T>(v);
      a_k[p] = rt<T>(v * s_b[p]);
    }
  }
  __syncthreads();

  // enc_q[:, e] is read once for all K lanes, eight pixel rows at a time
  // (the adds stay in pixel order)
  const int e0 = blockIdx.y * e_chunk;
  const int e1 = min(E, e0 + e_chunk);
  for (int e = e0 + tid; e < e1; e += blockDim.x) {
    float acc[kLaneGroup];
#pragma unroll
    for (int k = 0; k < kLaneGroup; ++k) acc[k] = 0.0f;
    int p = 0;
    for (; p + 8 <= pa; p += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = (float)enc_b[(size_t)(p + j) * E + e];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < kLaneGroup; ++k)
          if (k < kg) acc[k] += att[k * pa + p + j] * x[j];
    }
    for (; p < pa; ++p) {
      const float x = (float)enc_b[(size_t)p * E + e];
#pragma unroll
      for (int k = 0; k < kLaneGroup; ++k)
        if (k < kg) acc[k] += att[k * pa + p] * x;
    }
#pragma unroll
    for (int k = 0; k < kLaneGroup; ++k)
      if (k < kg) awe[((size_t)b * K + k0 + k) * E + e] = from_f<T>(acc[k]);
  }
}

template <typename T>
static int launch_attend_q(const void* enc_q, const void* enc_s,
                           const void* ea_q, const void* ea_s,
                           const void* dec, const void* wf, void* scores,
                           void* awe, void* alpha, int B, int K, int P,
                           int pa, int E, int A, int esplit,
                           cudaStream_t stream) {
  const int warps = kAttendQThreads / 32;
  const int kg = min(K, kLaneGroup);
  const int groups = (K + kLaneGroup - 1) / kLaneGroup;
  const size_t smem1 = sizeof(float) * ((size_t)kg * A + A);
  const size_t smem2 = sizeof(float) * (size_t)kg * pa;
  int err = allow_smem(attend_q_scores_kernel<T>, smem1);
  if (err == 0) err = allow_smem(attend_q_sum_kernel<T>, smem2);
  if (err != 0) return err;
  attend_q_scores_kernel<T>
      <<<dim3(B, (pa + warps - 1) / warps, groups), kAttendQThreads, smem1,
         stream>>>((const int8_t*)ea_q, (const float*)ea_s, (const T*)dec,
                   (const float*)wf, (float*)scores, K, P, pa, A);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int e_chunk = (E + esplit - 1) / esplit;
  attend_q_sum_kernel<T><<<dim3(B, esplit, groups), kAttendQThreads, smem2,
                           stream>>>(
      (const int8_t*)enc_q, (const float*)enc_s, (const float*)scores,
      (T*)awe, (T*)alpha, K, P, pa, E, e_chunk);
  return (int)cudaGetLastError();
}

}  // namespace iic

// enc_q (B, P, E) and ea_q (B, P, A) int8; enc_s and ea_s (B, P) float32;
// dec (B, K, A), awe (B, K, E) and alpha (B, K, pa; may be null) in the
// dtype's storage; wf (A,) and the scratch scores (B, K, pa) float32.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int iic_attend_q(int dtype, const void* enc_q, const void* enc_s,
                            const void* ea_q, const void* ea_s,
                            const void* dec, const void* wf, void* scores,
                            void* awe, void* alpha, int B, int K, int P,
                            int pa, int E, int A, int esplit, void* stream) {
  if (K < 1 || esplit < 1 || pa < 1 || pa > P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::launch_attend_q<float>(enc_q, enc_s, ea_q, ea_s, dec, wf,
                                       scores, awe, alpha, B, K, P, pa, E, A,
                                       esplit, s);
  if (dtype == iic::kBF16)
    return iic::launch_attend_q<__nv_bfloat16>(enc_q, enc_s, ea_q, ea_s, dec,
                                               wf, scores, awe, alpha, B, K,
                                               P, pa, E, A, esplit, s);
  return (int)cudaErrorInvalidValue;
}
