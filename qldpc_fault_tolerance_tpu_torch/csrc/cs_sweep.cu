// Combination sweep of ordered-statistics decoding (OSD-CS): per shot, score
// every candidate of weight <= 2 and keep the first minimum; with its
// planes, build first the per-shot planes the candidates' costs decompose
// over.
//
// Replaces the TPU kernel _cs_sweep_kernel
// (qldpc_fault_tolerance_tpu/ops/osd_cs_device.py:215, body _cs_sweep_chunk
// :166) and the plane pass that feeds it (XLA, :414-438).  That kernel
// scores candidates as one-hot selector planes times the per-shot panels on
// the MXU (e1t @ dplane, e2t @ xflat), chunk by chunk; the planes exist only
// to feed the matrix unit and are not carried over.  Here the candidates
// index the panels directly.
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
// Each thread scores candidates in ascending order with a strict < (so it
// keeps its first minimum), and a reduction takes the minimum cost, the
// lower index on a tie (score, warp_min).
//
// cs_sweep_launch (ops/osd_cs_device.py cs_sweep, plain version
// cs_sweep_plain) takes the planes: dplane (f, B) and xflat (w*w, B)
// float32, base (B,), batch minor as in the JAX package; only xflat's rows
// a*w + b with a < b are read.  A block of 8 warps takes 8 consecutive
// shots: its threads stage the 8 shots' columns of dplane and of those
// w*(w-1)/2 xflat rows, in pair order, into shared memory (8 consecutive
// floats, one 32-byte sector, per row), then each warp scores its shot.
// Bound: bytes.  Each shot reads f + w*(w-1)/2 + 1 floats once and writes 8
// bytes; the work is 2 operations per weight-1 candidate and 5 per pair.
//
// cs_sweep_rows_launch (cs_sweep_rows, plain version cs_planes then
// cs_sweep_plain) builds the planes itself, from the reduced matrix of the
// full elimination (W, m, B) int32 read at the shot's pivot rows pr (r*,
// B), the signed pivot costs s (r*, B), the free columns' costs (f, B) and
// permuted positions (f, B) int64, and base (B,):
//   dplane[j] = (sum over i of s_i * T[i, fp_j]) + cost_free[j]
//   X[a, b]   =  sum over i of s_i * T[i, fp_a] * T[i, fp_b],  a < b < w
// with T[i, c] bit c of pivot row i, each sum taken over i = 0, 1, ..., r*-1
// in that order (the order cs_planes states; a term with a zero bit adds an
// exact zero, so only the set bits add).  One block per shot: its threads
// stage the shot's r* pivot rows (r* * W words), the signed costs and the
// free positions in shared memory, then each thread builds one plane entry
// (a free column's dplane or a pair's X) walking the pivot rows, and the
// block scores the shot's candidates from the planes in shared memory.
// Nothing but the winner reaches device memory.  Bound: bytes: per shot the
// pivot rows' words that hold free columns, the pivot rows' indices and
// signed costs, the free columns' costs and positions and the base, read
// once; the plane sums' adds (one per set bit) are far below the float32
// rate.  Reading the rows is a gather: batch minor, each word of a shot
// lies in its own 32-byte sector, so the block stages the row indices first
// and keeps several independent loads of the words in flight.
#include <cuda_runtime.h>
#include <math.h>
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

// The first minimum of candidates t, t + nt, ... of one shot (the base,
// index 0, to start), with d[j] at D[j * st] and pair k's x at X[k * st].
__device__ __forceinline__ void score(const float* D, const float* X, int st,
                                      float bc, int f, int w, int t, int nt,
                                      float& best, int& bi) {
  best = bc;
  bi = 0;
  for (int j = t; j < f; j += nt) {
    const float c = bc + D[j * st];
    if (c < best) {
      best = c;
      bi = 1 + j;
    }
  }
  const int npairs = w * (w - 1) / 2;
  for (int k = t; k < npairs; k += nt) {
    int a, b;
    pair_of(k, w, &a, &b);
    const float c = (bc + (D[a * st] + D[b * st])) - 2.0f * X[k * st];
    if (c < best) {
      best = c;
      bi = 1 + f + k;
    }
  }
}

// the minimum cost over a warp, the lower index on a tie, in lane 0
__device__ __forceinline__ void warp_min(float& best, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (oc < best || (oc == best && oi < bi)) {
      best = oc;
      bi = oi;
    }
  }
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

  float best;
  int bi;
  score(D + s, X + s, kShots, base[b0 + s], f, w, lane, 32, best, bi);
  warp_min(best, bi);
  if (lane == 0) {
    best_cost[b0 + s] = best;
    best_idx[b0 + s] = bi;
  }
}

__global__ void __launch_bounds__(1024)
cs_sweep_rows_kernel(const int32_t* __restrict__ packed,     // (W, m, B)
                     const int32_t* __restrict__ pr,         // (r, B)
                     const float* __restrict__ signed_piv,   // (r, B)
                     const float* __restrict__ cost_free,    // (f, B)
                     const int64_t* __restrict__ free_perm,  // (f, B)
                     const float* __restrict__ base,         // (B,)
                     float* __restrict__ best_cost,          // (B,)
                     int32_t* __restrict__ best_idx,         // (B,)
                     int W, int m, int r, int f, int w, int B) {
  extern __shared__ __align__(16) unsigned char rows_smem[];
  __shared__ float s_best[32];
  __shared__ int s_bi[32];
  const int npairs = w * (w - 1) / 2;
  const int b = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  uint32_t* T = (uint32_t*)rows_smem;  // (r, W): pivot row i's words
  float* s = (float*)(T + (size_t)r * W);
  int* rows = (int*)(s + r);  // the pivot rows' indices
  int* fp = rows + r;
  float* D = (float*)(fp + f);
  float* X = D + f;  // pair k's X at k
  for (int i = t; i < r; i += nt) {
    s[i] = signed_piv[(size_t)i * B + b];
    rows[i] = pr[(size_t)i * B + b];
  }
  for (int j = t; j < f; j += nt) fp[j] = (int)free_perm[(size_t)j * B + b];
  __syncthreads();
  // the gather: every load independent of the others, several in flight
#pragma unroll 4
  for (int k = t; k < r * W; k += nt) {
    const int i = k / W, wd = k - i * W;
    T[k] = (uint32_t)packed[((size_t)wd * m + rows[i]) * B + b];
  }
  __syncthreads();

  // the planes: thread t builds dplane[t] (t < f) or pair t - f's X
  for (int e = t; e < f + npairs; e += nt) {
    float acc = 0.0f;
    if (e < f) {
      const int c = fp[e];
      const uint32_t* col = T + (c >> 5);
      const int sh = c & 31;
      for (int i = 0; i < r; ++i)
        if ((col[(size_t)i * W] >> sh) & 1u) acc += s[i];
      D[e] = acc + cost_free[(size_t)e * B + b];
    } else {
      int a, c;
      pair_of(e - f, w, &a, &c);
      const int ca = fp[a], cb = fp[c];
      const uint32_t* col_a = T + (ca >> 5);
      const uint32_t* col_b = T + (cb >> 5);
      const int sa = ca & 31, sb = cb & 31;
      for (int i = 0; i < r; ++i)
        if ((col_a[(size_t)i * W] >> sa) & (col_b[(size_t)i * W] >> sb) & 1u)
          acc += s[i];
      X[e - f] = acc;
    }
  }
  __syncthreads();

  float best;
  int bi;
  score(D, X, 1, base[b], f, w, t, nt, best, bi);
  warp_min(best, bi);
  const int warp = t >> 5, lane = t & 31, warps = (nt + 31) >> 5;
  if (lane == 0) {
    s_best[warp] = best;
    s_bi[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < warps ? s_best[lane] : INFINITY;
    bi = lane < warps ? s_bi[lane] : 0x7fffffff;
    warp_min(best, bi);
    if (lane == 0) {
      best_cost[b] = best;
      best_idx[b] = bi;
    }
  }
}

int set_smem(const void* kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

}  // namespace

extern "C" int cs_sweep_launch(const float* dplane, const float* xflat,
                               const float* base, float* best_cost,
                               int32_t* best_idx, int f, int w, int B,
                               int smem_bytes, void* stream) {
  const int e = set_smem((const void*)cs_sweep_kernel, smem_bytes);
  if (e != 0) return e;
  const int blocks = (B + kShots - 1) / kShots;
  cs_sweep_kernel<<<blocks, 32 * kShots, smem_bytes, (cudaStream_t)stream>>>(
      dplane, xflat, base, best_cost, best_idx, f, w, B);
  return (int)cudaGetLastError();
}

extern "C" int cs_sweep_rows_launch(const int32_t* packed, const int32_t* pr,
                                    const float* signed_piv,
                                    const float* cost_free,
                                    const int64_t* free_perm,
                                    const float* base, float* best_cost,
                                    int32_t* best_idx, int W, int m, int r,
                                    int f, int w, int B, int threads,
                                    int smem_bytes, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || r < 1 || f < 1 ||
      w < 0 || w > f)
    return -1;
  const int e = set_smem((const void*)cs_sweep_rows_kernel, smem_bytes);
  if (e != 0) return e;
  cs_sweep_rows_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      packed, pr, signed_piv, cost_free, free_perm, base, best_cost, best_idx,
      W, m, r, f, w, B);
  return (int)cudaGetLastError();
}
