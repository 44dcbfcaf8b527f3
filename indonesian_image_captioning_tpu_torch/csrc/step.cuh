// Kernel 2's cell and head kernels, shared by step.cu (their C entry
// points) and span.cu (the span and megakernel chains).  step.cu's header
// describes the chain they belong to.
#pragma once

#include <climits>

#include "common.cuh"

namespace iic {

// ---------------------------------------------------------------- cell ----

// pre (R, 4H) float32 gate pre-activations; c (R, H) -> h', c' (R, H).
template <typename T>
__global__ void cell_kernel(const float* __restrict__ pre,
                            const T* __restrict__ c, T* __restrict__ h_out,
                            T* __restrict__ c_out, int R, int H, int lstm,
                            const int* live) {
  if (skip(live)) return;
  const long long n = (long long)R * H;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long r = idx / H;
    const int j = (int)(idx % H);
    const float* p = pre + r * 4 * H;
    const float p0 = rt<T>(p[j]), p1 = rt<T>(p[H + j]);
    const float p2 = rt<T>(p[2 * H + j]), p3 = rt<T>(p[3 * H + j]);
    float ig, fg, og, gg;
    if (lstm) {  // torch order i, f, g, o
      ig = rt<T>(sigmoidf_(p0));
      fg = rt<T>(sigmoidf_(p1));
      gg = rt<T>(tanhf(p2));
      og = rt<T>(sigmoidf_(p3));
    } else {     // SCN order i, f, o, c
      ig = rt<T>(sigmoidf_(p0));
      fg = rt<T>(sigmoidf_(p1));
      og = rt<T>(sigmoidf_(p2));
      gg = rt<T>(tanhf(p3));
    }
    const float cn = rt<T>(rt<T>(fg * to_f(c[idx])) + rt<T>(ig * gg));
    const float hn = rt<T>(og * rt<T>(tanhf(cn)));
    h_out[idx] = from_f<T>(hn);
    c_out[idx] = from_f<T>(cn);
  }
}

template <typename T>
static int launch_cell(const void* pre, const void* c, void* h_out,
                       void* c_out, int R, int H, int lstm,
                       cudaStream_t stream, const int* live = nullptr) {
  const long long n = (long long)R * H;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  cell_kernel<T><<<blocks, threads, 0, stream>>>(
      (const float*)pre, (const T*)c, (T*)h_out, (T*)c_out, R, H, lstm, live);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- head ----

constexpr int kHeadThreads = 256;

// One block per row of logits (R, V) float32 -> topv, topi (R, K), lse (R).
// A round's winner is the largest value, ties going to the lowest vocab id,
// and takes no part in the later rounds: round q + 1 looks only at the
// entries that come after round q's winner (v, i) in the order (value
// descending, id ascending), which is the Pallas body's "mask the winner
// with NEG" on rows whose logits are finite, at O(1) a value for any K.
//
//   raw = 0 (kernel 2, step_pallas.py:343-370; the span kernel): the rounds
//     run on x - max, topv holds x - max and lse = log sum exp(x - max).
//   raw = 1 (the megakernel, decode_pallas.py:223-234): the rounds run on
//     the raw logits, lse = log(sum exp(x - max)) + max and topv = x - lse,
//     the log-probabilities themselves.
//   raw = 2 (the vocab head fc_topk.cu, fc_topk_pallas.py): as raw = 1,
//     but topv holds the raw logits x.
__global__ void __launch_bounds__(kHeadThreads)
head_topk_kernel(const float* __restrict__ logits, int V, int K,
                 float* __restrict__ topv, int* __restrict__ topi,
                 float* __restrict__ lse, int raw, const int* live) {
  if (skip(live)) return;
  __shared__ float red_v[kHeadThreads];
  __shared__ int red_i[kHeadThreads];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const float* row = logits + (size_t)r * V;

  float m = -INFINITY;
  for (int j = tid; j < V; j += blockDim.x) m = fmaxf(m, row[j]);
  red_v[tid] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red_v[tid] = fmaxf(red_v[tid], red_v[tid + s]);
    __syncthreads();
  }
  const float mrow = red_v[0];
  __syncthreads();

  float sum = 0.0f;
  for (int j = tid; j < V; j += blockDim.x) sum += expf(row[j] - mrow);
  red_v[tid] = sum;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red_v[tid] += red_v[tid + s];
    __syncthreads();
  }
  const float lrow = raw ? logf(red_v[0]) + mrow : logf(red_v[0]);
  if (tid == 0) lse[r] = lrow;
  __syncthreads();

  float pv = INFINITY;   // the previous round's winner
  int pi = -1;
  for (int q = 0; q < K; ++q) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < V; j += blockDim.x) {
      const float v = raw ? row[j] : row[j] - mrow;
      if (!(v < pv || (v == pv && j > pi))) continue;
      if (v > bv || (v == bv && j < bi)) {
        bv = v;
        bi = j;
      }
    }
    red_v[tid] = bv;
    red_i[tid] = bi;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
      if (tid < s) {
        const float ov = red_v[tid + s];
        const int oi = red_i[tid + s];
        if (ov > red_v[tid] || (ov == red_v[tid] && oi < red_i[tid])) {
          red_v[tid] = ov;
          red_i[tid] = oi;
        }
      }
      __syncthreads();
    }
    pv = red_v[0];
    pi = red_i[0];
    if (tid == 0) {
      topv[(size_t)r * K + q] = raw == 1 ? pv - lrow : pv;
      topi[(size_t)r * K + q] = pi;
    }
    __syncthreads();
  }
}

static int launch_head(const void* logits, int R, int V, int K, void* topv,
                       void* topi, void* lse, int raw, cudaStream_t stream,
                       const int* live = nullptr) {
  if (K < 1 || K > V) return (int)cudaErrorInvalidValue;
  head_topk_kernel<<<R, kHeadThreads, 0, stream>>>(
      (const float*)logits, V, K, (float*)topv, (int*)topi, (float*)lse, raw,
      live);
  return (int)cudaGetLastError();
}

}  // namespace iic
