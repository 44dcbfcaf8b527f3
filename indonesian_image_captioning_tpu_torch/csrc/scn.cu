// Kernel 12: the fused SCN decode step over R rows.
//
// Replaces indonesian_image_captioning_tpu/ops/scn_pallas.py
// scn_step_fused (body _gate_kernel on a (gate, row-block) grid), the
// step engine's SCN cell under ModelConfig.fused_cell.  Per gate g of
// (i, f, o, c):
//
//   tx      = (x @ w_x) * sem_x                  float32, (R, 4F)
//   th      = (h @ w_h) * sem_h                  float32, (R, 4F)
//   pre[g]  = tx[g] @ w_xp[g] + th[g] @ w_hp[g] + (b_x + b_h)[g]   float32
//   i, f, o = sigmoid(pre[0..2]);  g = tanh(pre[3])
//   c'      = f * c + i * g;  h' = o * tanh(c')  (float32; one cast to T)
//
// As in the Pallas body, tx and th stay float32 (never rounded to T):
// the second pair of products multiplies float32 rows by the T weights
// w_xp / w_hp.  The epilogue (scn_pallas.py:127-135, outside the Pallas
// body) stays float32 until the final cast of h' and c' -- unlike
// kernel 2's cell (step.cuh), which rounds the pre-activations and the
// gates to T as scn_cell.scn_step does.
//
// The chain of one C call: two launches of the shared GEMM (gemm.cuh)
// for tx and th (epilogue: times the semantic factor, float32 out), one
// for the four gates' pre-activations (the gates as gridDim.z, float32
// A sources against T weights, the bias in the epilogue), and the cell.
// Every product of the Pallas body runs in gemm_kernel.
//
// What bounds it: at the step engine's R = B*K = 160 rows and
// attention_scn's In = Emb + E = 2,560 it does 2 R (In + H) 4F +
// 16 R F H = 2.68 GFLOP against 34 MB of float32 weights: arithmetic
// (0.040 ms at 67 TFLOP/s float32) over bytes (0.010 ms).  What the design
// does about it, in this first version: the GEMM's 64 x 64 tiles read
// each weight column once per 64-row block and keep every intermediate
// but tx/th and the pre-activations (R x 12F floats) out of device
// memory.  Tensor cores (wgmma) are later work.
#include "gemm.cuh"

namespace iic {

// pre (R, 4H) float32 in gate order i, f, o, c; c (R, H) -> h', c'.
template <typename T>
__global__ void scn_cell_f32_kernel(const float* __restrict__ pre,
                                    const T* __restrict__ c,
                                    T* __restrict__ h_out,
                                    T* __restrict__ c_out, int R, int H) {
  const long long n = (long long)R * H;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long r = idx / H;
    const int j = (int)(idx % H);
    const float* p = pre + r * 4 * H;
    const float ig = sigmoidf_(p[j]);
    const float fg = sigmoidf_(p[H + j]);
    const float og = sigmoidf_(p[2 * H + j]);
    const float gg = tanhf(p[3 * H + j]);
    const float cn = fg * to_f(c[idx]) + ig * gg;
    h_out[idx] = from_f<T>(og * tanhf(cn));
    c_out[idx] = from_f<T>(cn);
  }
}

template <typename T>
static int scn_step(const void* x, const void* h, const void* c,
                    const void* semx, const void* semh, const void* wx,
                    const void* wh, const void* wxp, const void* whp,
                    const void* b, float* txh, float* pre, void* h_out,
                    void* c_out, int R, int In, int H, int F,
                    cudaStream_t s) {
  const int F4 = 4 * F;
  // tx into columns 0..4F of txh, th into 4F..8F
  GemmArgs g = {};
  g.a[0] = x; g.w[0] = wx; g.k[0] = In; g.lda[0] = In; g.ldw[0] = F4;
  g.aux = semx; g.ldaux = F4;
  g.c = txh; g.ldc = 2 * F4; g.c_f32 = 1;
  g.M = R; g.N = F4; g.epi = kEpiF32Mul;
  int err = launch_gemm<T>(g, 1, s);
  if (err != 0) return err;
  g.a[0] = h; g.w[0] = wh; g.k[0] = H; g.lda[0] = H;
  g.aux = semh; g.c = txh + F4;
  err = launch_gemm<T>(g, 1, s);
  if (err != 0) return err;
  // gate z reads columns zF.. of tx and th, w_xp[z] / w_hp[z] (F, H),
  // and writes columns zH.. of pre
  GemmArgs q = {};
  q.a[0] = txh; q.w[0] = wxp; q.k[0] = F; q.lda[0] = 2 * F4; q.ldw[0] = H;
  q.a[1] = txh + F4; q.w[1] = whp; q.k[1] = F; q.lda[1] = 2 * F4;
  q.ldw[1] = H;
  q.bias1 = b;
  q.c = pre; q.ldc = 4 * H; q.c_f32 = 1;
  q.M = R; q.N = H; q.epi = kEpiPre;
  q.za = F; q.zw = (long long)F * H; q.zc = H; q.zb = H;
  err = launch_gemm<T, float>(q, 4, s);
  if (err != 0) return err;
  const long long n = (long long)R * H;
  const int blocks = (int)((n + 255) / 256);
  scn_cell_f32_kernel<T><<<blocks, 256, 0, s>>>(
      pre, (const T*)c, (T*)h_out, (T*)c_out, R, H);
  return (int)cudaGetLastError();
}

}  // namespace iic

// x (R, In), h and c (R, H), semx and semh (R, 4F), w_x (In, 4F), w_h
// (H, 4F), w_xp and w_hp (4, F, H), b = b_x + b_h (4, H), h_out and c_out
// (R, H) in the dtype's storage; the scratch txh (R, 8F) and pre (R, 4H)
// float32.  Returns the CUDA error code of the launches (0 on success).
extern "C" int iic_scn_step(int dtype, const void* x, const void* h,
                            const void* c, const void* semx,
                            const void* semh, const void* wx, const void* wh,
                            const void* wxp, const void* whp, const void* b,
                            void* txh, void* pre, void* h_out, void* c_out,
                            int R, int In, int H, int F, void* stream) {
  if (R < 1 || In < 1 || H < 1 || F < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::scn_step<float>(x, h, c, semx, semh, wx, wh, wxp, whp, b,
                                (float*)txh, (float*)pre, h_out, c_out, R, In,
                                H, F, s);
  if (dtype == iic::kBF16)
    return iic::scn_step<__nv_bfloat16>(x, h, c, semx, semh, wx, wh, wxp, whp,
                                        b, (float*)txh, (float*)pre, h_out,
                                        c_out, R, In, H, F, s);
  return (int)cudaErrorInvalidValue;
}
