// Kernel 1's device code: one additive-attention step for K beam lanes of
// each image, shared by attend.cu (its C entry point) and span.cu (the
// span and megakernel chains).
//
// Replaces indonesian_image_captioning_tpu/ops/attention_pallas.py
// attend_fused_mxu (body _make_kernel_mxu), and through it attend_fused,
// attend_fused_v3 and attend_fused_t, which compute the same values:
//
//   att[k, p] = wf . relu(ea[p] + dec[k])      (b_full dropped: softmax
//   alpha[k]  = softmax_p(att[k])               is shift-invariant)
//   awe[k]    = sum_p alpha[k, p] * enc[p]
//
// dec = h @ W_da + b_da arrives precomputed (B, K, A).  Inputs and outputs
// are float32 or bfloat16; all arithmetic is float32.  As in the Pallas
// kernel, wf is rounded to the input type, and so is alpha before the
// weighted sum.
//
// What bounds it: reading the encoder state, P * (E + A) elements per
// image (196 * 2560 at the flagship dims, 2 MB at float32), against about
// K * P * (3A + 2E) flops -- well under one flop per byte, so device memory
// bandwidth, not arithmetic, sets the time.
//
// What the design does about it: every byte of the encoder state is read
// once per step for each group of up to eight lanes (all K lanes together
// at K <= 8), in two launches.  The first
// reads ea: one warp per pixel keeps the K partial scores in registers and
// writes the (B, K, P) float32 score table (25 KB per image, the only
// intermediate that reaches device memory).  The second reads enc: each
// block takes one image's scores into shared memory, runs the softmax, and
// one thread per enc column keeps K sums.  Both grids carry enough blocks
// to fill the 132 SMs at B=32 (pixel groups for the first, column splits
// for the second), and each thread keeps several independent loads in
// flight, since at this size the loads' latency, not the bus, is what a
// block waits on.  Any K: each lane's attention is independent of the
// others', so a beam wider than the eight-lane register body runs as
// ceil(K / 8) lane groups, the grid's z dimension in both launches.
#pragma once

#include "common.cuh"

namespace iic {

constexpr int kAttendThreads = 256;

// Scores: one warp per pixel; ea[p, :] is read once for the block's lanes
// k0 .. k0 + kg - 1 (k0 = 8 * blockIdx.z).  Grid (B, ceil(P / warps per
// block), lane groups).  scores (B, K, P) float32.
template <typename T>
__global__ void __launch_bounds__(kAttendThreads)
attend_scores_kernel(const T* __restrict__ ea, const T* __restrict__ dec,
                     const float* __restrict__ wf, float* __restrict__ scores,
                     int K, int P, int A, const int* live) {
  if (skip(live)) return;
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
  if (p >= P) return;

  float acc[kLaneGroup];
#pragma unroll
  for (int k = 0; k < kLaneGroup; ++k) acc[k] = 0.0f;
  const T* row = ea + ((size_t)b * P + p) * A;
#pragma unroll 4
  for (int a = lane; a < A; a += 32) {
    const float x = to_f(row[a]);
    const float w = wf_s[a];
#pragma unroll
    for (int k = 0; k < kLaneGroup; ++k) {
      if (k < kg) {
        const float e = rt<T>(x + dec_s[k * A + a]);
        acc[k] += fmaxf(e, 0.0f) * w;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kLaneGroup; ++k) {
    if (k < kg) {
      const float v = warp_sum(acc[k]);
      if (lane == 0) scores[((size_t)b * K + k0 + k) * P + p] = v;
    }
  }
}

// Softmax over the P pixels, then the weighted sum over this block's
// columns, for the lanes k0 .. k0 + kg - 1 of lane group blockIdx.z.  Grid
// (B, esplit, lane groups); every block of an image recomputes its lanes'
// tiny kg x P softmax, and block y == 0 writes their alpha.
template <typename T>
__global__ void __launch_bounds__(kAttendThreads)
attend_sum_kernel(const T* __restrict__ enc,
                  const float* __restrict__ scores, T* __restrict__ awe,
                  T* __restrict__ alpha, int K, int P, int E, int e_chunk,
                  const int* live) {
  if (skip(live)) return;
  extern __shared__ float smem[];
  float* att = smem;            // kg * P: scores, then alpha
  const int k0 = blockIdx.z * kLaneGroup;
  const int kg = min(kLaneGroup, K - k0);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const T* enc_b = enc + (size_t)b * P * E;

  for (int i = tid; i < kg * P; i += blockDim.x)
    att[i] = scores[((size_t)b * K + k0) * P + i];
  __syncthreads();

  for (int k = warp; k < kg; k += nwarps) {
    float* a_k = att + k * P;
    float m = -INFINITY;
    for (int p = lane; p < P; p += 32) m = fmaxf(m, a_k[p]);
    m = warp_max(m);
    float s = 0.0f;
    for (int p = lane; p < P; p += 32) s += expf(a_k[p] - m);
    s = warp_sum(s);
    for (int p = lane; p < P; p += 32) {
      const float v = rt<T>(expf(a_k[p] - m) / s);
      a_k[p] = v;
      if (alpha != nullptr && blockIdx.y == 0)
        alpha[((size_t)b * K + k0 + k) * P + p] = from_f<T>(v);
    }
  }
  __syncthreads();

  // enc[:, e] is read once for all K lanes; eight pixel rows per
  // iteration keep eight independent loads in flight per thread (the adds
  // stay in pixel order).
  const int e0 = blockIdx.y * e_chunk;
  const int e1 = min(E, e0 + e_chunk);
  for (int e = e0 + tid; e < e1; e += blockDim.x) {
    float acc[kLaneGroup];
#pragma unroll
    for (int k = 0; k < kLaneGroup; ++k) acc[k] = 0.0f;
    int p = 0;
    for (; p + 8 <= P; p += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = to_f(enc_b[(size_t)(p + j) * E + e]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < kLaneGroup; ++k)
          if (k < kg) acc[k] += att[k * P + p + j] * x[j];
    }
    for (; p < P; ++p) {
      const float x = to_f(enc_b[(size_t)p * E + e]);
#pragma unroll
      for (int k = 0; k < kLaneGroup; ++k)
        if (k < kg) acc[k] += att[k * P + p] * x;
    }
#pragma unroll
    for (int k = 0; k < kLaneGroup; ++k)
      if (k < kg) awe[((size_t)b * K + k0 + k) * E + e] = from_f<T>(acc[k]);
  }
}

// Both launches; alpha and live may be null.  Returns the CUDA error code.
template <typename T>
static int launch_attend(const void* enc, const void* ea, const void* dec,
                         const void* wf, void* scores, void* awe, void* alpha,
                         int B, int K, int P, int E, int A, int esplit,
                         cudaStream_t stream, const int* live = nullptr) {
  const int warps = kAttendThreads / 32;
  const int kg = min(K, kLaneGroup);
  const int groups = (K + kLaneGroup - 1) / kLaneGroup;
  const size_t smem1 = sizeof(float) * ((size_t)kg * A + A);
  const size_t smem2 = sizeof(float) * (size_t)kg * P;
  int err = allow_smem(attend_scores_kernel<T>, smem1);
  if (err == 0) err = allow_smem(attend_sum_kernel<T>, smem2);
  if (err != 0) return err;
  attend_scores_kernel<T><<<dim3(B, (P + warps - 1) / warps, groups),
                            kAttendThreads, smem1, stream>>>(
      (const T*)ea, (const T*)dec, (const float*)wf, (float*)scores, K, P, A,
      live);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int e_chunk = (E + esplit - 1) / esplit;
  attend_sum_kernel<T><<<dim3(B, esplit, groups), kAttendThreads, smem2,
                         stream>>>(
      (const T*)enc, (const float*)scores, (T*)awe, (T*)alpha, K, P, E,
      e_chunk, live);
  return (int)cudaGetLastError();
}

}  // namespace iic
