// The decode chains' cell, head and selection kernels, shared by step.cu
// (kernels 2, 6b, 6c and the megakernel 13) and span.cu (kernel 7).
// step.cu's header describes the step chain, span.cu's the selection.
#pragma once

#include <climits>

#include "common.cuh"

namespace iic {

// ---------------------------------------------------------------- cell ----

// pre (R, 4H) float32 gate pre-activations; c (R, H) -> h', c' (R, H).
template <typename T>
__global__ void cell_kernel(const float* __restrict__ pre,
                            const T* __restrict__ c, T* __restrict__ h_out,
                            T* __restrict__ c_out, int R, int H, int lstm) {
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
                       cudaStream_t stream) {
  const long long n = (long long)R * H;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  cell_kernel<T><<<blocks, threads, 0, stream>>>(
      (const float*)pre, (const T*)c, (T*)h_out, (T*)c_out, R, H, lstm);
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
      topv[(size_t)r * K + q] = raw ? pv - lrow : pv;
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

// ------------------------------------------------------------ select ----

constexpr int kSelectThreads = 128;

struct SelectArgs {
  const float* topv;     // (R, K) float32
  const int* topi;       // (R, K)
  const float* lse;      // (R,), or null when topv holds log-probabilities
  const float* sc_in;    // (R,) the scores before the step
  const int* pw_in;      // (R,)
  const int* alive_in;   // (B,)
  float* sc;             // (R,) after the step (may equal sc_in)
  int* pw;
  int* alive;
  const void* h_new;     // (R, D) the cell's output
  const void* c_new;
  const void* h_src;     // (R, D) the state before the step
  const void* c_src;
  void* h;               // (R, D) the state after the step (may equal h_src)
  void* c;
  int* words;            // (B, rec_steps, K)
  int* parents;
  float* vals;
  int K, D, end_id, freeze, step, rec_steps;
  const int* live_in;    // this step's early-exit word, or null
  int* live_out;         // the next step's, or null
};

// One block per image.  Candidate j = k' * K + q (lane k' of the image,
// its q-th word) is max(sc + (topv - lse), NEG), NEG where sc <= NEG,
// computed where it is read.  Round q takes, among the values above NEG,
// the largest that comes after round q - 1's winner in the order (value
// descending, flat index ascending): lax.top_k's order, the Pallas body's
// K rounds of max / lowest-index argmax / mask with NEG.  Once no value
// above NEG is left every round takes flat index 0 at NEG, as masking
// does when all K*K values are NEG.  Nothing is kept per candidate or per
// winner, so any K fits: the winners go straight to the records (a
// round writes its flat index, turned into word and parent after the
// rounds), which the bookkeeping and the reorder read back.
template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
select_kernel(SelectArgs a) {
  if (skip(a.live_in)) return;
  __shared__ int s_upd;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int K = a.K, KK = K * K, D = a.D;
  const long long rec = ((long long)b * a.rec_steps + a.step) * K;
  auto cand = [&](int j) {
    const int r = b * K + j / K;
    const long long t = (long long)r * K + j % K;
    const float s = a.sc_in[r];
    const float lp = a.lse != nullptr ? a.topv[t] - a.lse[r] : a.topv[t];
    const float v = fmaxf(s + lp, kNeg);
    return s <= kNeg ? kNeg : v;
  };

  // the K rounds, in warp 0
  if (tid < 32) {
    float pv = INFINITY;   // the previous round's winner
    int pi = -1;
    for (int q = 0; q < K; ++q) {
      float bv = kNeg;
      int bi = INT_MAX;
      if (pv > kNeg) {
        for (int j = tid; j < KK; j += 32) {
          const float v = cand(j);
          if (!(v > kNeg) || !(v < pv || (v == pv && j > pi))) continue;
          if (v > bv || (v == bv && j < bi)) {
            bv = v;
            bi = j;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
          }
        }
      }
      if (bi == INT_MAX) bi = 0;   // none left: index 0 at NEG
      pv = bv;
      pi = bi;
      if (tid == 0) {
        a.words[rec + q] = bi;       // the flat index, for now
        a.vals[rec + q] = bv;
      }
    }
  }
  __syncthreads();
  for (int k = tid; k < K; k += blockDim.x) {
    const int flat = a.words[rec + k];
    a.words[rec + k] = a.topi[(long long)(b * K + flat / K) * K + flat % K];
    a.parents[rec + k] = flat / K;
  }
  __syncthreads();

  if (tid == 0) {
    const int al = a.alive_in[b];
    const int upd = !a.freeze || al > 0;
    int n_done = 0;
    for (int k = 0; k < K; ++k) {
      const float tv = a.vals[rec + k];
      const int word = a.words[rec + k];
      const int r = b * K + k;
      if (upd) {
        const bool valid = k < al && tv > kNeg;
        const bool is_end = valid && word == a.end_id;
        n_done += is_end;
        a.sc[r] = (valid && !is_end) ? tv : kNeg;
        a.pw[r] = word;
      } else {
        a.sc[r] = a.sc_in[r];
        a.pw[r] = a.pw_in[r];
      }
    }
    const int na = al - n_done;
    a.alive[b] = na;
    if (a.live_out != nullptr && na > 0) atomicOr(a.live_out, 1);
    s_upd = upd;
  }
  __syncthreads();

  // The reorder: lane k of the image takes its parent's new (h, c); a
  // frozen image keeps its state.  Rows are read from buffers the step
  // wrote and written to the carried state, never in place.
  const bool upd = s_upd != 0;
  if (!upd && a.h == a.h_src) return;
  const T* hs = (const T*)(upd ? a.h_new : a.h_src);
  const T* cs = (const T*)(upd ? a.c_new : a.c_src);
  T* h = (T*)a.h;
  T* c = (T*)a.c;
  for (int idx = tid; idx < K * D; idx += blockDim.x) {
    const int k = idx / D;
    const int j = idx % D;
    const long long src =
        (long long)(b * K + (upd ? a.parents[rec + k] : k)) * D + j;
    const long long dst = (long long)(b * K + k) * D + j;
    h[dst] = hs[src];
    c[dst] = cs[src];
  }
}

}  // namespace iic
