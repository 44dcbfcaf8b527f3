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
// Two launches of the swap-AB tensor-core GEMM at its wide batch tile
// (mma_small.cuh, kSmWide: the rows are wgmma's N, each W tile read once
// per 160 rows), on K-major packs made once per weight tree
// (ops/scn_cuda.py scn_packs):
//
//   S1  tx and th, two products of one launch, epilogue v * sem in
//       float32 (kSmF32Mul); 3xTF32 at float32, bf16 wgmma at bfloat16
//   S2  the four gates of 64 units in one cluster, the float32 cell in the
//       epilogue (kSmScnCell); A is tx and th in float32 at both types, so
//       S2 is the float32 instance: 3xTF32 at float32, and at bfloat16
//       2xTF32 on W's bfloat16 values held as float32 (exact in TF32, so
//       W has no lo part) with tx and th split into TF32 hi and lo parts
//       in shared memory (kSmScnCellBf) -- a bf16 product would round them
//
// Every product of the Pallas body runs in these two launches; no library
// GEMM is called and no float32 FFMA GEMM.
//
// What bounds it: at the step engine's R = B*K = 160 rows and
// attention_scn's In = Emb + E = 2,560 it does 2 R (In + H) 4F +
// 16 R F H = 2.68 GFLOP against 34 MB of float32 weights: arithmetic at
// the 3xTF32 rate (0.016 ms at 495 / 3 TFLOP/s) over bytes (0.010 ms).
// What the design does about it: the products run on the tensor cores,
// split over K inside thread-block clusters (no partial reaches device
// memory), the cell runs in S2's epilogue, and what passes between the
// launches is tx and th, R x 8F floats.
#include "mma_small.cuh"

namespace iic {

// Everything one call needs.  Every field is 8 bytes; ops/scn_cuda.py
// mirrors it field for field and checks its size against
// iic_scn_args_bytes().  x (R, In), h and c (R, H), semx and semh (R, 4F)
// in T; wx (4F, ldwx) and wh (4F, ldwh) the K-major packs of w_x and w_h
// in T; wg the gate-interleaved pack of [w_xp_g | w_hp_g] (4 Hp, ldwg),
// float32 at both types, w_hp's half wg_o1 values in; b = b_x + b_h (4H)
// float32; the scratch tx, th (R, 4F) float32; h_out, c_out (R, H) in T.
struct ScnArgs {
  long long R, In, H, F, ldwx, ldwh, ldwg, wg_o1;
  const void *x, *h, *c, *semx, *semh, *wx, *wh, *wg, *b;
  void *tx, *th, *h_out, *c_out;
};

// Launches of the last iic_scn_step call.
static long long g_scn_launches = 0;

template <typename T>
static int scn_step(const ScnArgs& r, cudaStream_t s) {
  constexpr bool kBf = sizeof(T) == 2;
  const int R = (int)r.R, In = (int)r.In, H = (int)r.H, F = (int)r.F;
  const int F4 = 4 * F, Hp = (H + kSmM - 1) / kSmM * kSmM;
  g_scn_launches = 0;
  // S1: tx = (x @ w_x) sem_x and th = (h @ w_h) sem_h
  SmallLaunch L = {};
  L.nprob = 2;
  L.B = R;
  L.p[0] = small_prob(F4, kSmF32Mul);
  small_src(L.p[0], r.x, In, r.wx, r.ldwx, F4, In);
  L.p[0].aux = r.semx, L.p[0].ldaux = F4;
  L.p[0].out = r.tx, L.p[0].ldo = F4;
  L.p[1] = small_prob(F4, kSmF32Mul);
  small_src(L.p[1], r.h, H, r.wh, r.ldwh, F4, H);
  L.p[1].aux = r.semh, L.p[1].ldaux = F4;
  L.p[1].out = r.th, L.p[1].ldo = F4;
  ++g_scn_launches;
  const int err = launch_small<T, kSmF32Mul, kSmWide>(L, s);
  if (err != 0) return err;
  // S2: the gates of 64 units in one cluster, the cell in the epilogue
  constexpr int kCell = kBf ? kSmScnCellBf : kSmScnCell;
  SmallLaunch G = {};
  G.nprob = 1;
  G.B = R;
  SmallProb& pc = G.p[0];
  pc = small_prob(H, kCell);
  gates_interleaved(pc);
  pc.zx = F;
  small_src(pc, r.tx, F4, r.wg, r.ldwg, 4 * Hp, F);
  small_src(pc, r.th, F4, (const float*)r.wg + r.wg_o1, r.ldwg, 4 * Hp, F);
  pc.bias1 = r.b;
  pc.aux3 = r.c, pc.ldaux3 = H;
  pc.out = r.h_out, pc.ldo = H;
  pc.out2 = r.c_out, pc.ldo2 = H;
  ++g_scn_launches;
  return launch_small<float, kCell, kSmWide>(G, s);
}

}  // namespace iic

extern "C" int iic_scn_args_bytes() { return (int)sizeof(iic::ScnArgs); }

// Kernel launches of the last iic_scn_step call.
extern "C" int iic_scn_launches() { return (int)iic::g_scn_launches; }

// Kernel 12 over r.R rows.  Returns the first failing launch's CUDA error
// code, 0 on success.
extern "C" int iic_scn_step(int dtype, const void* args, void* stream) {
  const iic::ScnArgs& r = *(const iic::ScnArgs*)args;
  if (r.R < 1 || r.In < 1 || r.H < 1 || r.F < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32) return iic::scn_step<float>(r, s);
  if (dtype == iic::kBF16) return iic::scn_step<__nv_bfloat16>(r, s);
  return (int)cudaErrorInvalidValue;
}
