// Per-shot GF(2) Gauss-Jordan elimination for ordered-statistics decoding.
//
// One per-column walk, in three modes, replaces three TPU kernels:
//   * kSkip (osd_elim_launch): _elim_blocked_kernel
//     (qldpc_fault_tolerance_tpu/ops/osd_device.py:547, bodies
//     _blocked_stepA :477 and _blocked_phaseB_delta :530), the OSD-E route.
//     Five outputs: reduced syndrome, pivot rows, pivot columns, free-panel
//     words, free-column positions.
//   * kFull (osd_elim_full_launch): _elim_blocked_full_kernel (:632), the
//     OSD-CS route: the same five outputs plus the fully reduced matrix.
//   * kPercol (osd_elim_percol_launch): _elim_kernel (:343), the per-column
//     route behind QLDPC_OSD_ELIM=pallas_percol: the reduced syndrome, the
//     pivots, the pivot-column flags ip (n, B) and the reduced matrix; no free
//     panel.
// The TPU's blocked kernels work 32 columns per block step so that a tile
// touches the matrix twice per block; the blocking is a TPU choice and is not
// carried over.  All three modes compute their outputs one column at a time.
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
//     rows lane, lane+32, ...: the augmented syndrome, the free panel (when
//     fcap > 0) and the row's words from the pivot's word rightwards.  The
//     pivot row is zero at every column already walked (each earlier pivot
//     cleared its column from every unused row, and a walked column without
//     a pivot had no unused row set, or came once the rank was r* and no
//     row is cleared again), so the words to its left would change
//     no bit: the matrix in shared memory is the full RREF in every mode,
//     and kFull and kPercol write it out;
//   * a column without a pivot is free: its bits are recorded at bit fcnt of
//     every row's free-panel word and its position at fpos[fcnt], for the
//     first fcap free columns (kSkip, kFull);
//   * columns t >= n are padding and never pivot;
//   * the warp stops once its rank is r* and it has fcap free columns
//     (kPercol: fcap is 0).  The free panel fword is written only when fcap
//     > 0 (it is all zero otherwise; the wrapper zeroes it).
// The wrapper refuses shapes whose matrix does not fit in shared memory
// (232,448 bytes per block; hgp_34_n1600 needs 162,816).
//
// Bound: integer word operations on shared memory.  A processed column costs
// one test of each of the m rows plus, for each row it clears, (W - w + 1)
// word XORs (its words from the pivot's and its syndrome) and one more for
// its free-panel word when fcap > 0; the count depends on the data and is
// computed per run by ops/osd_device.py elimination_work.  Device memory
// sees each input word read once and each output word the kernel writes
// written once (the matrix, in kFull and kPercol, is W*m words per shot;
// of the zeroed ip and fpos it writes r* and at most fcap words).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kSkip = 0, kFull = 1, kPercol = 2 };

template <int kMode>
__global__ void __launch_bounds__(32)
osd_elim_kernel(const int32_t* __restrict__ packed,  // (W, m, B)
                const int32_t* __restrict__ synd_in, // (m, B)
                int32_t* __restrict__ synd_out,      // (m, B)
                int32_t* __restrict__ pr,            // (r*, B) zeroed
                int32_t* __restrict__ pc,            // (r*, B) zeroed
                int32_t* __restrict__ fword_out,     // (m, B); fcap > 0 only
                int32_t* __restrict__ fpos,          // (32, B) zeroed; not kPercol
                int32_t* __restrict__ packed_out,    // (W, m, B); not kSkip
                int32_t* __restrict__ ip,            // (n, B) zeroed; kPercol
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
        if (fcap > 0) F[r] ^= pf;
      }
      if (lane == 0) {
        U[piv] = 1;
        pr[rank * sB + b] = piv;
        pc[rank * sB + b] = t;
        if (kMode == kPercol) ip[t * sB + b] = 1;
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
    if (kMode != kPercol && fcap > 0) fword_out[r * sB + b] = F[r];
  }
  if (kMode != kSkip) {
    for (size_t i = lane; i < words; i += 32) packed_out[i * sB + b] = M[i];
  }
}

template <int kMode>
int launch(const int32_t* packed, const int32_t* synd_in, int32_t* synd_out,
           int32_t* pr, int32_t* pc, int32_t* fword, int32_t* fpos,
           int32_t* packed_out, int32_t* ip, int m, int n, int W, int r_star,
           int fcap, int B, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        osd_elim_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  osd_elim_kernel<kMode><<<B, 32, smem_bytes, (cudaStream_t)stream>>>(
      packed, synd_in, synd_out, pr, pc, fword, fpos, packed_out, ip, m, n, W,
      r_star, fcap, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int osd_elim_launch(const int32_t* packed, const int32_t* synd_in,
                               int32_t* synd_out, int32_t* pr, int32_t* pc,
                               int32_t* fword, int32_t* fpos, int m, int n,
                               int W, int r_star, int fcap,
                               int B, int smem_bytes, void* stream) {
  return launch<kSkip>(packed, synd_in, synd_out, pr, pc, fword, fpos,
                       nullptr, nullptr, m, n, W, r_star, fcap, B, smem_bytes,
                       stream);
}

extern "C" int osd_elim_full_launch(const int32_t* packed,
                                    const int32_t* synd_in, int32_t* synd_out,
                                    int32_t* pr, int32_t* pc, int32_t* fword,
                                    int32_t* fpos, int32_t* packed_out, int m,
                                    int n, int W, int r_star, int fcap, int B,
                                    int smem_bytes, void* stream) {
  return launch<kFull>(packed, synd_in, synd_out, pr, pc, fword, fpos,
                       packed_out, nullptr, m, n, W, r_star, fcap, B,
                       smem_bytes, stream);
}

extern "C" int osd_elim_percol_launch(const int32_t* packed,
                                      const int32_t* synd_in,
                                      int32_t* synd_out, int32_t* pr,
                                      int32_t* pc, int32_t* ip,
                                      int32_t* packed_out, int m, int n,
                                      int W, int r_star, int B,
                                      int smem_bytes, void* stream) {
  return launch<kPercol>(packed, synd_in, synd_out, pr, pc, nullptr, nullptr,
                         packed_out, ip, m, n, W, r_star, 0, B, smem_bytes,
                         stream);
}
