// Kernel 2: the kernels of one fused beam-decode step over R = B*K rows.
//
// Replaces indonesian_image_captioning_tpu/ops/step_pallas.py
// fused_decode_step and fused_decode_step_noattn (body _make_kernel, call
// _fused_call).  The Pallas body is one kernel; here the step is a short
// chain of launches of the kernels below plus kernel 1 (attend.cu), driven
// by ops/step_cuda.py:
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
// What the design does about it, in this first version: the GEMM tiles
// 64 x 64 outputs per block with 16-deep float32 tiles in shared memory (a
// weight column is read once per 64-row block, not once per row); the
// elementwise work (bias, sigmoid gate, semantic modulation) is fused into
// the GEMM epilogues so no pre-activation makes a round trip except the
// gate pre-activations and the logits; the head reads each logit row from
// L2 for its K + 2 passes.  Tensor-core (wgmma) tiles, TMA and a head that
// never writes the logits are later work.
#include <climits>

#include "common.cuh"

namespace iic {

constexpr int kMaxK = 8;
constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------- GEMM ----

constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

enum Epilogue {
  kEpiBias = 0,        // rt(rt(acc) + b1), as dot(...).astype(dt) + b
  kEpiPre = 1,         // acc + b1 + b2 in float32 (gate pre-activations)
  kEpiSigmoidMul = 2,  // rt(rt(sigmoid(rt(rt(acc) + b1))) * aux)
  kEpiMul = 3,         // rt(rt(acc) * aux)
};

// C[z] = epilogue(A1[z] @ W1[z] + A2[z] @ W2[z]): two sources accumulate
// into one sum (a product over a concatenated input); z offsets the
// columns of A, C and aux, the elements of W and of the biases.
struct GemmArgs {
  const void* a[2];
  const void* w[2];
  int k[2];
  long long lda[2];
  long long ldw[2];
  const void* bias1;
  const void* bias2;
  const void* aux;
  long long ldaux;
  void* c;
  long long ldc;
  int c_f32;
  int M, N, epi;
  long long za, zw, zc, zb;
};

template <typename T>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  __shared__ float As[kBK][kBM];
  __shared__ float Ws[kBK][kBN];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 output columns each
  const int ty = tid / 16;  // 4 output rows each

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < 2; ++s) {
    if (g.a[s] == nullptr) continue;
    const T* A = (const T*)g.a[s] + z * g.za;
    const T* W = (const T*)g.w[s] + z * g.zw;
    const int Kd = g.k[s];
    const long long lda = g.lda[s];
    const long long ldw = g.ldw[s];
    for (int k0 = 0; k0 < Kd; k0 += kBK) {
#pragma unroll
      for (int i = 0; i < (kBM * kBK) / kGemmThreads; ++i) {
        const int idx = tid + i * kGemmThreads;
        const int r = idx / kBK, kk = idx % kBK;
        const int gm = m0 + r, gk = k0 + kk;
        As[kk][r] = (gm < g.M && gk < Kd) ? to_f(A[gm * lda + gk]) : 0.0f;
        const int wr = idx / kBN, wc = idx % kBN;
        const int wk = k0 + wr, wn = n0 + wc;
        Ws[wr][wc] = (wk < Kd && wn < g.N) ? to_f(W[wk * ldw + wn]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const T* b1 = g.bias1 ? (const T*)g.bias1 + z * g.zb : nullptr;
  const T* b2 = g.bias2 ? (const T*)g.bias2 + z * g.zb : nullptr;
  const T* aux = g.aux ? (const T*)g.aux + z * g.zc : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= g.N) continue;
      float v = acc[i][j];
      switch (g.epi) {
        case kEpiBias:
          v = rt<T>(v);
          if (b1) v = rt<T>(v + to_f(b1[gn]));
          break;
        case kEpiPre:
          if (b1) v += to_f(b1[gn]);
          if (b2) v += to_f(b2[gn]);
          break;
        case kEpiSigmoidMul: {
          float x = rt<T>(v);
          if (b1) x = rt<T>(x + to_f(b1[gn]));
          const float gate = rt<T>(sigmoidf_(x));
          v = rt<T>(gate * to_f(aux[gm * g.ldaux + gn]));
          break;
        }
        case kEpiMul:
          v = rt<T>(rt<T>(v) * to_f(aux[gm * g.ldaux + gn]));
          break;
      }
      const long long ci = gm * g.ldc + z * g.zc + gn;
      if (g.c_f32)
        ((float*)g.c)[ci] = v;
      else
        ((T*)g.c)[ci] = from_f<T>(v);
    }
  }
}

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

// ---------------------------------------------------------------- head ----

constexpr int kHeadThreads = 256;

// One block per row of logits (R, V) float32 -> topv, topi (R, K), lse (R).
__global__ void __launch_bounds__(kHeadThreads)
head_topk_kernel(const float* __restrict__ logits, int V, int K,
                 float* __restrict__ topv, int* __restrict__ topi,
                 float* __restrict__ lse) {
  __shared__ float red_v[kHeadThreads];
  __shared__ int red_i[kHeadThreads];
  __shared__ int sel[kMaxK];
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
  if (tid == 0) lse[r] = logf(red_v[0]);
  __syncthreads();

  for (int q = 0; q < K; ++q) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < V; j += blockDim.x) {
      float v = row[j] - mrow;
      for (int t = 0; t < q; ++t)
        if (sel[t] == j) v = kNeg;
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
    if (tid == 0) {
      topv[(size_t)r * K + q] = red_v[0];
      topi[(size_t)r * K + q] = red_i[0];
      sel[q] = red_i[0];
    }
    __syncthreads();
  }
}

template <typename T>
static int launch_gemm(const GemmArgs& g, int nz, cudaStream_t stream) {
  dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, nz);
  gemm_kernel<T><<<grid, kGemmThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
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

}  // namespace iic

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
  iic::GemmArgs g;
  g.a[0] = a1; g.w[0] = w1; g.k[0] = k1; g.lda[0] = lda1; g.ldw[0] = ldw1;
  g.a[1] = a2; g.w[1] = w2; g.k[1] = k2; g.lda[1] = lda2; g.ldw[1] = ldw2;
  g.bias1 = bias1; g.bias2 = bias2; g.aux = aux; g.ldaux = ldaux;
  g.c = c; g.ldc = ldc; g.c_f32 = c_f32;
  g.M = M; g.N = N; g.epi = epi;
  g.za = za; g.zw = zw; g.zc = zc; g.zb = zb;
  if (M < 1 || N < 1 || nz < 1 || epi < 0 || epi > 3)
    return (int)cudaErrorInvalidValue;
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
  if (K < 1 || K > iic::kMaxK || K > V) return (int)cudaErrorInvalidValue;
  iic::head_topk_kernel<<<R, iic::kHeadThreads, 0, (cudaStream_t)stream>>>(
      (const float*)logits, V, K, (float*)topv, (int*)topi, (float*)lse);
  return (int)cudaGetLastError();
}
