// Combination sweep of ordered-statistics decoding (OSD-CS): per shot, score
// every candidate of weight <= 2 and keep the first minimum.
//
// Replaces the TPU kernel _cs_sweep_kernel
// (qldpc_fault_tolerance_tpu/ops/osd_cs_device.py:215, body _cs_sweep_chunk
// :166).  That kernel scores candidates as one-hot selector planes times the
// per-shot panels on the MXU (e1t @ dplane, e2t @ xflat), chunk by chunk; the
// planes exist only to feed the matrix unit and are not carried over.  Here
// the candidates index the panels directly.
//
// Candidates of a shot, in the host enumeration order: index 0 is the base
// (OSD-0) solution; 1..f flip one free column j = index - 1; then the pairs
// (a, b), a < b < w, in lexicographic order.  With d = dplane[:, shot] and
// x = xflat[:, shot] the costs are, in float32, what the TPU's
// HIGHEST-precision products give (a product against a 0/1 row with one or
// two ones adds exact zeros):
//   base:     base
//   weight 1: base + d[j]
//   pair:     (base + (d[a] + d[b])) - 2 * x[a * w + b]
// Built with -fmad=false, so nothing contracts into an FMA.  The TPU kernel
// keeps the first minimum within each chunk and a strict-< carry across
// chunks, which together are the global first minimum: no chunks here.
//
// Layout: dplane (f, B) and xflat (w*w, B) float32, base (B,), batch minor
// as in the JAX package; only xflat's rows a*w + b with a < b are read.  A
// block of 8 warps takes 8 consecutive shots: its threads stage the 8 shots'
// columns of dplane and of those w*(w-1)/2 xflat rows, in pair order, into
// shared memory (8 consecutive floats, one 32-byte sector, per row), then
// each warp scores its shot, lanes striding the candidates in ascending
// order with a strict < (so each lane keeps its first minimum), and a
// shuffle reduction takes the minimum cost, the lower index on a tie.  The
// wrapper refuses panels whose 8-shot stage does not fit in shared memory.
//
// Bound: bytes.  Each shot reads f + w*(w-1)/2 + 1 floats once and writes 8
// bytes; the work is 2 operations per weight-1 candidate and 5 per pair.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kShots = 8;

// The k-th pair (a, b), a < b < w, in lexicographic order: row a holds the
// w - 1 - a pairs (a, a+1) .. (a, w-1).
__device__ __forceinline__ void pair_of(int k, int w, int* a, int* b) {
  int r = 0;
  while (k >= w - 1 - r) {
    k -= w - 1 - r;
    ++r;
  }
  *a = r;
  *b = r + 1 + k;
}

__global__ void __launch_bounds__(32 * kShots)
cs_sweep_kernel(const float* __restrict__ dplane,  // (f, B)
                const float* __restrict__ xflat,   // (wsq, B)
                const float* __restrict__ base,    // (B,)
                float* __restrict__ best_cost,     // (B,)
                int32_t* __restrict__ best_idx,    // (B,)
                int f, int w, int B) {
  extern __shared__ float smem[];
  const int npairs = w * (w - 1) / 2;
  float* D = smem;             // (f, kShots)
  float* X = D + f * kShots;   // (npairs, kShots): x[a*w+b] of pair k at k
  const int b0 = blockIdx.x * kShots;
  const int nb = min(kShots, B - b0);
  for (int i = threadIdx.x; i < f * kShots; i += blockDim.x) {
    const int s = i % kShots;
    D[i] = s < nb ? dplane[(size_t)(i / kShots) * B + b0 + s] : 0.0f;
  }
  for (int i = threadIdx.x; i < npairs * kShots; i += blockDim.x) {
    const int s = i % kShots;
    int a, b;
    pair_of(i / kShots, w, &a, &b);
    X[i] = s < nb ? xflat[(size_t)(a * w + b) * B + b0 + s] : 0.0f;
  }
  __syncthreads();
  const int s = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= nb) return;  // whole warps only: s is one value per warp

  const float bc = base[b0 + s];
  float best = bc;
  int bi = 0;
  for (int j = lane; j < f; j += 32) {
    const float c = bc + D[j * kShots + s];
    if (c < best) {
      best = c;
      bi = 1 + j;
    }
  }
  for (int k = lane; k < npairs; k += 32) {
    int a, b;
    pair_of(k, w, &a, &b);
    const float c = (bc + (D[a * kShots + s] + D[b * kShots + s]))
                    - 2.0f * X[k * kShots + s];
    if (c < best) {
      best = c;
      bi = 1 + f + k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (oc < best || (oc == best && oi < bi)) {
      best = oc;
      bi = oi;
    }
  }
  if (lane == 0) {
    best_cost[b0 + s] = best;
    best_idx[b0 + s] = bi;
  }
}

}  // namespace

extern "C" int cs_sweep_launch(const float* dplane, const float* xflat,
                               const float* base, float* best_cost,
                               int32_t* best_idx, int f, int w, int B,
                               int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cs_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + kShots - 1) / kShots;
  cs_sweep_kernel<<<blocks, 32 * kShots, smem_bytes, (cudaStream_t)stream>>>(
      dplane, xflat, base, best_cost, best_idx, f, w, B);
  return (int)cudaGetLastError();
}
