// Kernel 14: the embedding table's gradient, d_table[ids[n]] += g[n] over
// N = B * T caption tokens, into a (V, E) float32 table.
//
// Replaces indonesian_image_captioning_tpu/ops/embed_grad_pallas.py
// embed_grad_scatter (body _kernel).  The Pallas kernel contracts a
// one-hot tile against g on the MXU, because Mosaic cannot express a
// scatter into a row chosen by a token id; here the scatter is written
// directly.  Its contract holds: g float32 or bfloat16, accumulated in
// float32; ids outside [0, V) add nothing (the one-hot of such an id is
// zero), so padded rows with id 0 and zero g add nothing either.
//
// What bounds it: each g row read once, each table row written once, and
// one add per g element -- device memory bandwidth, (V*E*4 + N*E*isz +
// N*4) bytes.
//
// What the design does about it, and what it gives up: one block owns a
// (kRows x kCols) tile of the table in shared memory, so no two blocks
// write one element and no atomics are used.  The block streams all N ids
// in rounds of kCols (one per thread), compacts the tokens whose id falls
// in its rows into a list in token order (a warp ballot and a prefix count
// across the four warps), and each thread then adds its column of every
// listed g row, kDepth rows loaded ahead, the running sum of the current
// row in a register.  Each table element is therefore the sum of its
// tokens in token order, as a sequential np.add.at is, and bitwise the
// same from run to run.  Every g row is read once per column slice.  The
// price: every block reads all N ids (424 blocks x N x 4 bytes at
// V = 6,763, E = 512, mostly from L2), and the blocks holding id 0 add
// every padded token, kDepth loads at a time.
#include "common.cuh"

namespace iic {

constexpr int kRows = 64;       // vocabulary rows per block
constexpr int kCols = 128;      // table columns per block, one per thread
constexpr int kList = 2048;     // listed tokens held before they are added
constexpr int kDepth = 32;      // g loads in flight per thread

template <typename T>
__global__ void __launch_bounds__(kCols)
embed_grad_kernel(const int* __restrict__ ids, const T* __restrict__ g,
                  int N, int V, int E, float* __restrict__ out) {
  __shared__ float acc[kRows][kCols];
  __shared__ int tok[kList];
  __shared__ unsigned char row[kList];
  __shared__ int warp_cnt[kCols / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * kRows;
  const int col = blockIdx.y * kCols + tid;
#pragma unroll 8
  for (int r = 0; r < kRows; ++r) acc[r][tid] = 0.0f;

  int count = 0;                       // the same in every thread
  // the row being summed stays in a register while consecutive listed
  // tokens hit it (padding: long runs of id 0); acc[cur_r] is stale
  // until it is stored back
  int cur_r = 0;
  float cur = 0.0f;
  int id_next = tid < N ? ids[tid] : 0;    // the next round's id, ahead
  for (int n0 = 0; n0 < N; n0 += kCols) {
    const int n = n0 + tid;
    const int id = id_next;
    if (n + kCols < N) id_next = ids[n + kCols];
    int r = -1;
    if (n < N) {
      const unsigned d = (unsigned)id - (unsigned)v0;
      if (d < (unsigned)kRows) r = (int)d;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, r >= 0);
    if (lane == 0) warp_cnt[warp] = __popc(hit);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kCols / 32; ++w) {
      const int c = warp_cnt[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (r >= 0) {
      const int pos = count + before + __popc(hit & ((1u << lane) - 1u));
      tok[pos] = n;
      row[pos] = (unsigned char)r;
    }
    count += total;
    __syncthreads();                   // the list is written; warp_cnt read
    if (count > kList - kCols || n0 + kCols >= N) {
      if (col < E) {
        const T* gc = g + col;
        for (int j0 = 0; j0 < count; j0 += kDepth) {
          // kDepth loads in flight, unconditional: past the list's end a
          // slot reloads its last token and its row is -1 (skipped)
          int rw[kDepth];
          float v[kDepth];
#pragma unroll
          for (int u = 0; u < kDepth; ++u) {
            const int j = min(j0 + u, count - 1);
            rw[u] = j0 + u < count ? (int)row[j] : -1;
            v[u] = to_f(__ldg(gc + (long long)tok[j] * E));
          }
#pragma unroll
          for (int u = 0; u < kDepth; ++u) {
            if (rw[u] >= 0) {
              if (rw[u] != cur_r) {
                acc[cur_r][tid] = cur;
                cur_r = rw[u];
                cur = acc[cur_r][tid];
              }
              cur += v[u];
            }
          }
        }
      }
      count = 0;
      __syncthreads();                 // the list is read before reuse
    }
  }
  if (col < E) {
    acc[cur_r][tid] = cur;
    for (int r = 0; r < kRows && v0 + r < V; ++r)
      out[(long long)(v0 + r) * E + col] = acc[r][tid];
  }
}

template <typename T>
static int launch_embed_grad(const void* ids, const void* g, int N, int V,
                             int E, void* out, cudaStream_t s) {
  const dim3 grid((V + kRows - 1) / kRows, (E + kCols - 1) / kCols);
  embed_grad_kernel<T><<<grid, kCols, 0, s>>>(
      (const int*)ids, (const T*)g, N, V, E, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace iic

// ids (N,) int32; g (N, E) in the dtype's storage, row-major; out (V, E)
// float32, every element written.  Returns the launch's CUDA error code.
extern "C" int iic_embed_grad(int dtype, const void* ids, const void* g,
                              int N, int V, int E, void* out, void* stream) {
  if (N < 0 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == iic::kF32)
    return iic::launch_embed_grad<float>(ids, g, N, V, E, out, s);
  if (dtype == iic::kBF16)
    return iic::launch_embed_grad<__nv_bfloat16>(ids, g, N, V, E, out, s);
  return (int)cudaErrorInvalidValue;
}
