// Per-shot GF(2) Gauss-Jordan elimination for ordered-statistics decoding.
//
// Replaces the TPU kernel _elim_blocked_kernel
// (qldpc_fault_tolerance_tpu/ops/osd_device.py:547, bodies _blocked_stepA
// :477 and _blocked_phaseB_delta :530).  That kernel works 32 columns per
// block step so that a TPU tile touches the matrix twice per block; the
// blocking is a TPU choice and is not carried over.  This kernel computes the
// same five outputs (reduced syndrome, pivot rows, pivot columns, free-panel
// words, free-column positions) one column at a time.
//
// Input: the reliability-permuted H of every shot, rows bit-packed into int32
// words, (W, m, B) with permuted column t at word t >> 5, bit t & 31; the
// syndrome (m, B).  One warp per shot copies its shot's matrix, syndrome and
// free panel into shared memory (one block per shot, so the shots spread over
// every SM) and walks the columns in order:
//   * the pivot is the first unused row with the column's bit set, taken
//     only while the shot's rank is below r*: the warp tests 32 rows at a
//     time and a ballot picks the lowest;
//   * a pivot clears the column from every other row, each lane taking the
//     rows lane, lane+32, ...: the words from the pivot's word rightwards
//     (words to its left are never read again), the augmented syndrome and
//     the free panel;
//   * a column without a pivot is free: its bits are recorded at bit fcnt of
//     every row's free-panel word and its position at fpos[fcnt], for the
//     first fcap free columns;
//   * columns t >= n are padding and never pivot;
//   * the warp stops once its rank is r* and it has fcap free columns.
// The wrapper refuses shapes whose matrix does not fit in shared memory
// (232,448 bytes per block; hgp_34_n1600 needs 162,816).
//
// Bound: integer word operations on shared memory.  A processed column costs
// one test of each of the m rows plus, for each row it clears, (W - w + 2)
// word XORs; the count depends on the data and is computed per run by
// ops/osd_device.py elimination_work.  Device memory sees each input word
// read once and each output word written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(32)
osd_elim_kernel(const int32_t* __restrict__ packed,  // (W, m, B)
                const int32_t* __restrict__ synd_in, // (m, B)
                int32_t* __restrict__ synd_out,      // (m, B)
                int32_t* __restrict__ pr,            // (r*, B) zeroed
                int32_t* __restrict__ pc,            // (r*, B) zeroed
                int32_t* __restrict__ fword_out,     // (m, B)
                int32_t* __restrict__ fpos,          // (32, B) zeroed
                int m, int n, int W, int r_star, int fcap, int B) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const size_t sB = (size_t)B;
  const size_t words = (size_t)W * m;
  int32_t* M = smem;       // the shot's matrix, (W, m)
  int32_t* S = M + words;  // reduced syndrome
  int32_t* F = S + m;      // free panel
  int32_t* U = F + m;      // row already a pivot

  for (size_t i = lane; i < words; i += 32) M[i] = packed[i * sB + b];
  for (int r = lane; r < m; r += 32) {
    S[r] = synd_in[r * sB + b];
    F[r] = 0;
    U[r] = 0;
  }
  __syncwarp();

  int rank = 0;
  int fcnt = 0;
  for (int t = 0; t < n; ++t) {
    if (rank >= r_star && fcnt >= fcap) break;
    const int w = t >> 5;
    const unsigned j = (unsigned)(t & 31);
    const int32_t* col = M + (size_t)w * m;
    int piv = -1;
    if (rank < r_star) {
      for (int r0 = 0; r0 < m; r0 += 32) {
        const int r = r0 + lane;
        const bool cand = r < m && !U[r] && (((unsigned)col[r] >> j) & 1u);
        const unsigned ballot = __ballot_sync(0xffffffffu, cand);
        if (ballot) {
          piv = r0 + __ffs(ballot) - 1;
          break;
        }
      }
    }
    if (piv >= 0) {
      const int32_t ps = S[piv];
      const int32_t pf = F[piv];
      for (int r = lane; r < m; r += 32) {
        if (r == piv || !(((unsigned)col[r] >> j) & 1u)) continue;
        for (int ww = w; ww < W; ++ww) {
          M[(size_t)ww * m + r] ^= M[(size_t)ww * m + piv];
        }
        S[r] ^= ps;
        F[r] ^= pf;
      }
      if (lane == 0) {
        U[piv] = 1;
        pr[rank * sB + b] = piv;
        pc[rank * sB + b] = t;
      }
      ++rank;
    } else if (fcnt < fcap) {
      for (int r = lane; r < m; r += 32) {
        F[r] ^= (int32_t)((((unsigned)col[r] >> j) & 1u) << fcnt);
      }
      if (lane == 0) fpos[fcnt * sB + b] = t;
      ++fcnt;
    }
    __syncwarp();
  }

  for (int r = lane; r < m; r += 32) {
    synd_out[r * sB + b] = S[r];
    fword_out[r * sB + b] = F[r];
  }
}

}  // namespace

extern "C" int osd_elim_launch(const int32_t* packed, const int32_t* synd_in,
                               int32_t* synd_out, int32_t* pr, int32_t* pc,
                               int32_t* fword, int32_t* fpos, int m, int n,
                               int W, int r_star, int fcap,
                               int B, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        osd_elim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  osd_elim_kernel<<<B, 32, smem_bytes, (cudaStream_t)stream>>>(
      packed, synd_in, synd_out, pr, pc, fword, fpos, m, n, W, r_star, fcap,
      B);
  return (int)cudaGetLastError();
}
