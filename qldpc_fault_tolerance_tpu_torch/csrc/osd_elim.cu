// Per-shot GF(2) Gauss-Jordan elimination for ordered-statistics decoding.
//
// One column walk, in three modes, replaces three TPU kernels:
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
// What bounds it on an H100.  A shot's elimination is a chain of r*
// dependent pivot steps (300 at hgp_34_n625; ~560 columns walked), and the
// main path runs it on 128-512 shots, 1-4 per SM.  So the time is one
// shot's chain, and what counts is the latency of a step, not the card's
// word rate (the bounds are microseconds).  One warp per shot walking m rows
// per column (the first port) took ~8,000 cycles per column; a step is now
// ~1,100 cycles, most of them dependent shared-memory loads, warp votes and
// shuffles at tens of cycles each, and one barrier.  The design:
//
//   * one block per shot, its matrix column-packed in shared memory: column
//     c's m bits in mW = ceil(m/32) words, stored word-major (A[w * P + c],
//     P = (n + 1) | 1, odd, so a warp reading one word of 32 columns, or 32
//     words of one column, hits 32 banks); the syndrome is column n.  The
//     kernel builds the columns itself from the shot's permutation and the
//     code's column-packed H (colpack (n, mW), which stays in L1/L2), so no
//     (W, m, B) matrix is packed and transposed in device memory first.
//   * warp 0 walks: it keeps the used rows and the step in registers, and
//     in the step of pivot (t, row) it clears the kWindow columns after t
//     itself (lane (j, g): column t + 1 + j, words g, g + 4, ...), tests
//     them for the next pivot as they come out (the lowest row outside the
//     used ones, while the rank is below r*: a min-reduction over the warp),
//     records the free columns before it, and publishes the next pivot in a
//     two-entry slot.  When none of the window's columns has a pivot, or
//     the matrix is taller than its lanes hold, it publishes a rescan and
//     walks on after the barrier, 32 columns at a time.
//   * warps 1.. clear the columns right of the window, every (warps - 1)-th
//     column to a warp (an even warp count keeps that stride odd and the
//     loads on 32 banks): a lane tests its column's bit at the pivot row, a
//     ballot gathers the set ones, and the lanes XOR the pivot column
//     (without its pivot bit; a lane holds one word of it) into them,
//     32 / mW columns at a time.  The pivot bit of a column never changes in
//     its step and every column has one writer, so nothing races; one
//     __syncthreads ends the step.
//   * columns left of t need nothing: the pivot row is zero there (each
//     earlier pivot cleared its column from every unused row, and a walked
//     column without a pivot had no unused row set, or came once the rank
//     was r* and no step follows).  The pivot column itself is left as it
//     was (every thread reads it during its step); in the reduced matrix it
//     is the unit vector at its pivot row, and kFull and kPercol write it so.
//   * outputs: the pivots and free columns from shared memory; the reduced
//     syndrome from column n; the free panel (kSkip, kFull with fcap > 0)
//     read once after the walk: bit k of fword[r] is bit r of column
//     fpos[k], which is what the TPU kernel's row-wise panel holds after
//     every later clear; the reduced matrix (kFull, kPercol) in the
//     row-packed (W, m, B) layout, by 32 x 32 bit transposes with warp
//     ballots.
//   * ops/osd_device.py elim_layout chooses the threads from the batch: the
//     shots an SM holds share 1024 threads (~64 registers a thread), so
//     128-512 shots get 256-640 threads each and 2048 shots 128.
//
// Shared memory per block: 4 * (mW * P + mW + 6 + 32 + 2 m) bytes: 27,672
// at hgp_34_n625, 98,184 at n1225 and 160,088 at n1600.  Syndromes are 0/1
// words.
//
// Device-memory mode (kGlobal, a template flag; ops/osd_device.py
// elim_layout picks it where one shot's matrix does not fit the 232,448
// bytes a block may take, e.g. [H|I] of hgp_34_n1600, 768 x 2368, 233,816
// bytes).  The shot's column-packed matrix and syndrome live in a
// per-launch scratch tensor, mW * P words per shot (block b's at
// scratch + b * mW * P, same layout); the used rows, the walk's state, the
// free positions and the pivots stay in shared memory, 4 * (mW + 6 + 32 +
// 2 m) bytes.  The walk, its order and its arithmetic are the
// shared-memory mode's, so the outputs are bit for bit the same;
// __syncthreads orders the block's device-memory writes as it orders its
// shared ones.  The shared-memory instantiations are unchanged.  The
// scratch is the last kernel argument, so the others keep their offsets.
//
// Transform mode (kTransform, a template flag after kGlobal; kSkip and kFull
// only; elim_layout takes it where the matrix does not fit shared memory
// and the transform does).  kGlobal's time was one shot's chain of pivot
// steps, each testing ~1,970 columns of a 227 KB scratch far past L2 (20.95
// ms at phase 30's 2048 shots).  The reduced matrix is T A, T (m x m) the
// product of the walk's row operations, which starts as the identity and
// does not depend on n.  So shared memory holds T column-packed in the
// matrix's layout (column j at T[w * Q + j], Q = (m + 2) | 1, odd; the
// syndrome at column m, zero at column m + 1) with each permuted column's
// rows (rows_s (cw, n) uint16, m + 1 past a column's weight, so a gather
// reads the zero column and never branches): 101,080 bytes at [H|I] of
// hgp_34_n1600, two shots an SM.  A column of T A is gathered as the XOR
// of T's columns at its rows.  A step is kGlobal's, on T, with the gathers
// off warp 0's chain (measured: a window gathered by warp 0 itself cost
// ~1,100 cycles a step, as much as the rest of its step):
//   * warp 0 reads its window's kWindow columns from a two-entry buffer
//     (win), clears, tests and publishes as before, and writes the next
//     pivot column, which T does not hold, to a two-entry buffer (pcol);
//     it does not read T in a step;
//   * meanwhile warps 1.. test bit p of T's m + 1 columns and XOR the
//     pivot column, without its pivot bit, into the set ones (m + 1
//     columns instead of n - t + 1);
//   * after a __syncthreads (every update done, the next step published)
//     warps 1.. gather the next step's window from T into win, a word a
//     lane, and a second __syncthreads ends the step;
//   * the walk starts with a rescan; in a rescan warp 0 scans T (gathering
//     each column it tests) while warps 1.. wait, and they then gather the
//     window of the pivot it published;
//   * after the walk (rank r* or not, T frozen) the syndrome is T's column
//     m, and the free panel and kFull's matrix are T a_c gathered from T,
//     32 columns a warp through ballot_transpose (a pivot column's T a_c is
//     its unit vector).
// The gathers read the same bits that kGlobal's matrix holds, so the
// outputs are bit for bit the other modes'.
//
// Bound: integer word operations on shared memory.  A pivot step tests one
// word of each column right of t and XORs the pivot column's words into the
// set ones; ops/osd_device.py elimination_work counts the row-wise walk's
// operations per run, which chip_smoke.py takes for the operations bound
// (and for the transform mode the smaller of that and transform_work, the
// transform walk's count).  Device memory sees the permutation, the
// syndromes and colpack (or the row lists) read once and each output word
// written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kSkip = 0, kFull = 1, kPercol = 2 };
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxThreads = 1024;

// lane j of the warp gets the word whose bit i is bit j of lane i's x
__device__ __forceinline__ uint32_t ballot_transpose(uint32_t x, int lane) {
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t v = __ballot_sync(kAll, (x >> j) & 1u);
    if (lane == j) mine = v;
  }
  return mine;
}

// Warp 0's walk state and its steps: it finds the pivots, records them and
// the free columns in shared memory, and publishes each step in a two-entry
// slot that the other warps read after the next barrier.
struct Walk {
  int rank;  // pivots published
  int fcnt;  // free columns recorded (at most fcap)
  int t0;    // first column not yet walked
  int2 out;  // what warp 0 published last: (column or kDone/kRescan, row)
};

constexpr int kDone = -1;    // slot: the walk has ended
constexpr int kRescan = -2;  // slot: warp 0 scans on after the barrier
// warp 0 clears the kWindow columns after each pivot itself and looks for
// the next pivot among them, 4 lanes a column: kWl words a lane, so
// matrices of up to 4 * kWl words a column (kernels for kWl 1, 2, 3, 4, 6,
// 8; taller ones walk without the window)
constexpr int kWindow = 8;
constexpr int kNone = 1 << 30;

// mark row piv used in a window lane's words g, g + 4, ...
template <int kWl>
__device__ __forceinline__ void mark_used(uint32_t (&used)[kWl], int g,
                                          int piv) {
#pragma unroll
  for (int i = 0; i < kWl; ++i) {
    if (g + 4 * i == (piv >> 5)) used[i] |= 1u << (piv & 31);
  }
}

// publish (t, piv) or a kDone / kRescan in `out`
__device__ __forceinline__ void publish(Walk& wk, int t, int piv, int lane,
                                        int* out) {
  wk.out = make_int2(t, piv);
  if (lane == 0) *reinterpret_cast<int2*>(out) = wk.out;
}

// record pivot (t, piv), with its row in U when `keep_u`, and publish it
__device__ __forceinline__ void publish_pivot(Walk& wk, int t, int piv,
                                              int lane, uint32_t* U, int* out,
                                              int* pr_s, int* pc_s,
                                              bool keep_u) {
  publish(wk, t, piv, lane, out);
  if (lane == 0) {
    if (keep_u) U[piv >> 5] |= 1u << (piv & 31);
    pr_s[wk.rank] = piv;
    pc_s[wk.rank] = t;
  }
  ++wk.rank;
  wk.t0 = t + 1;
}

// record the free columns t .. t + nfree - 1 (lane j: column t + j), as far
// as fcap allows
__device__ __forceinline__ void record_free(Walk& wk, int t, int nfree,
                                            int lane, int fcap, int* fpos_s) {
  if (lane < nfree && wk.fcnt + lane < fcap) fpos_s[wk.fcnt + lane] = t + lane;
  wk.fcnt = min(fcap, wk.fcnt + max(nfree, 0));
}

// warp 0: walk on from wk.t0 over columns that are final, 32 at a time (lane
// j tests column t0 + j for a row outside the used ones; the columns before
// the first such are free), and publish the next pivot (returning its row)
// or the end (returning -1)
__device__ int scan(Walk& wk, const uint32_t* A, uint32_t* U, int* out,
                    int* fpos_s, int* pr_s, int* pc_s, int lane, int mW, int P,
                    int n, int r_star, int fcap) {
  while (wk.t0 < n && (wk.rank < r_star || wk.fcnt < fcap)) {
    const int c = wk.t0 + lane;
    uint32_t acc = 0u;
    if (wk.rank < r_star && c < n) {
      for (int w = 0; w < mW; ++w) acc |= A[w * P + c] & ~U[w];
    }
    const unsigned cand = __ballot_sync(kAll, acc != 0u);
    const int upto = cand ? __ffs(cand) - 1 : 32;
    record_free(wk, wk.t0, min(upto, n - wk.t0), lane, fcap, fpos_s);
    if (cand) {
      const int t = wk.t0 + upto;
      int piv = 0;
      for (int wb = 0; wb < mW; wb += 32) {
        const int w = wb + lane;
        const uint32_t x = w < mW ? A[w * P + t] & ~U[w] : 0u;
        const unsigned any = __ballot_sync(kAll, x != 0u);
        if (any) {
          const int lw = __ffs(any) - 1;
          piv = ((wb + lw) << 5) + __ffs(__shfl_sync(kAll, x, lw)) - 1;
          break;
        }
      }
      publish_pivot(wk, t, piv, lane, U, out, pr_s, pc_s, true);
      return piv;
    }
    wk.t0 += 32;
  }
  publish(wk, kDone, 0, lane, out);
  return -1;
}

// ---------------------------------------------------------- transform mode

// column c's first four rows, m + 1 (T's zero column) past its weight or
// where the column is not `in` the matrix
struct Rows4 {
  int r[4];
};
__device__ __forceinline__ Rows4 rows4(const uint16_t* rows_s, int n, int cw,
                                       int m, int c, bool in) {
  Rows4 x;
#pragma unroll
  for (int k = 0; k < 4; ++k) x.r[k] = in && k < cw ? rows_s[k * n + c] : m + 1;
  return x;
}

// word w of column c of T A: the XOR of T's columns at c's rows (`rr`, and
// past four from rows_s), its loads issued together
__device__ __forceinline__ uint32_t gather_word(const uint32_t* T,
                                                const uint16_t* rows_s,
                                                const Rows4& rr, int n, int cw,
                                                int Q, int c, int w) {
  const uint32_t* Tw = T + w * Q;
  uint32_t x = (Tw[rr.r[0]] ^ Tw[rr.r[1]]) ^ (Tw[rr.r[2]] ^ Tw[rr.r[3]]);
  for (int k = 4; k < cw; ++k) x ^= Tw[rows_s[k * n + c]];
  return x;
}

// scan over T: lane j gathers column t0 + j; the pivot column, gathered a
// word a lane, goes to pcol_out
__device__ int scan_transform(Walk& wk, const uint32_t* T,
                              const uint16_t* rows_s, uint32_t* U, int* out,
                              uint32_t* pcol_out, int* fpos_s, int* pr_s,
                              int* pc_s, int lane, int mW, int Q, int m, int n,
                              int cw, int r_star, int fcap) {
  while (wk.t0 < n && (wk.rank < r_star || wk.fcnt < fcap)) {
    const int c = wk.t0 + lane;
    uint32_t acc = 0u;
    if (wk.rank < r_star && c < n) {
      const Rows4 rr = rows4(rows_s, n, cw, m, c, true);
      for (int w = 0; w < mW; ++w) {
        acc |= gather_word(T, rows_s, rr, n, cw, Q, c, w) & ~U[w];
      }
    }
    const unsigned cand = __ballot_sync(kAll, acc != 0u);
    const int upto = cand ? __ffs(cand) - 1 : 32;
    record_free(wk, wk.t0, min(upto, n - wk.t0), lane, fcap, fpos_s);
    if (cand) {
      const int t = wk.t0 + upto;
      const Rows4 rt = rows4(rows_s, n, cw, m, t, true);
      int piv = -1;
      for (int wb = 0; wb < mW; wb += 32) {
        const int w = wb + lane;
        uint32_t f = 0u;
        if (w < mW) {
          const uint32_t x = gather_word(T, rows_s, rt, n, cw, Q, t, w);
          pcol_out[w] = x;
          f = x & ~U[w];
        }
        const unsigned any = __ballot_sync(kAll, f != 0u);
        if (any && piv < 0) {
          const int lw = __ffs(any) - 1;
          piv = ((wb + lw) << 5) + __ffs(__shfl_sync(kAll, f, lw)) - 1;
        }
      }
      publish_pivot(wk, t, piv, lane, U, out, pr_s, pc_s, true);
      return piv;
    }
    wk.t0 += 32;
  }
  publish(wk, kDone, 0, lane, out);
  return -1;
}

// the transform mode's kernel body (header comment): shared memory holds
// T (mW, Q), U (mW), pcol (2, mW), win (2, kWindow, mW), the slot and
// counts, fpos_s (32), pr_s and pc_s (m each) and rows_s (cw, n) uint16
template <int kMode, int kWl>
__device__ __forceinline__ void elim_transform(
    uint32_t* smem, const int64_t* __restrict__ perm,
    const int32_t* __restrict__ synd_in, int32_t* __restrict__ synd_out,
    int32_t* __restrict__ pr, int32_t* __restrict__ pc,
    int32_t* __restrict__ fword_out, int32_t* __restrict__ fpos,
    int32_t* __restrict__ packed_out, int m, int n, int r_star, int fcap,
    int B, const int16_t* __restrict__ rows, int cw) {
  const int mW = (m + 31) >> 5;
  const int Q = (m + 2) | 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nt = blockDim.x;
  const int nw = nt >> 5;
  uint32_t* T = smem;                        // (mW, Q): T, the syndrome at m
  uint32_t* U = T + (size_t)mW * Q;          // (mW): used rows
  uint32_t* pcol = U + mW;                   // (2, mW): the steps' pivot columns
  uint32_t* win = pcol + 2 * mW;             // (2, kWindow, mW): their windows
  int* slot = (int*)(win + 2 * kWindow * mW);  // (2, 2): pivot column and row
  int* counts = slot + 4;                    // (2): pivots, free columns
  int* fpos_s = counts + 2;                  // (32): free columns
  int* pr_s = fpos_s + 32;                   // (m): pivot rows
  int* pc_s = pr_s + m;                      // (m): pivot columns
  uint16_t* rows_s = (uint16_t*)(pc_s + m);  // (cw, n): the columns' rows
  const int b = blockIdx.x;
  const size_t sB = (size_t)B;

  const int64_t* perm_b = perm + (size_t)b * n;
  for (int c = tid; c < n; c += nt) {
    const int16_t* src = rows + (size_t)perm_b[c] * cw;
    for (int k = 0; k < cw; ++k) {
      const int r = src[k];
      rows_s[k * n + c] = (uint16_t)(r >= 0 && r < m ? r : m + 1);
    }
  }
  for (int i = tid; i < mW * Q; i += nt) {
    const int w = i / Q;
    const int j = i - w * Q;
    if (j != m) T[i] = j < m && (j >> 5) == w ? 1u << (j & 31) : 0u;
  }
  for (int w = warp; w < mW; w += nw) {
    const int r = (w << 5) + lane;
    const unsigned bits = __ballot_sync(kAll, r < m && (synd_in[r * sB + b] & 1));
    if (lane == 0) T[w * Q + m] = bits;
  }
  for (int i = tid; i < mW; i += nt) U[i] = 0u;
  if (tid == 0) *reinterpret_cast<int2*>(slot) = make_int2(kRescan, 0);
  __syncthreads();

  // the first iteration scans from column 0
  Walk wk{0, 0, 0, make_int2(kRescan, 0)};
  const int g = lane & 3;
  uint32_t used[kWl] = {};  // warp 0's used rows, its words
  const int G = mW <= 32 ? 32 / mW : 1;
  const int sub = mW <= 32 && lane < G * mW ? lane / mW : 32;
  const int wl = mW <= 32 ? lane - (lane / mW) * mW : 0;
  const int nw1 = nw - 1;
  int par = 0;
  const bool windowed = mW <= 4 * kWl;
  for (;;) {
    const int2 step = warp == 0 ? wk.out
                                : *reinterpret_cast<const int2*>(slot + 2 * par);
    const int t = step.x;
    if (t == kDone) break;
    const uint32_t* pv = pcol + par * mW;  // column t, as the step found it
    // columns t + 1 .. t + kWindow, reduced by the steps before t
    const uint32_t* wv = win + par * kWindow * mW;
    par ^= 1;
    int* nxt = slot + 2 * par;
    uint32_t* pnxt = pcol + par * mW;
    const int piv = step.y;
    const int pw = piv >> 5;
    const uint32_t pbit = 1u << (piv & 31);
    if (warp == 0) {
      if (t == kRescan) {
        if (windowed) {  // U from the window lanes' words
#pragma unroll
          for (int i = 0; i < kWl; ++i) {
            if (lane < 4 && lane + 4 * i < mW) U[lane + 4 * i] = used[i];
          }
          __syncwarp();
        }
        const int piv1 = scan_transform(wk, T, rows_s, U, nxt, pnxt, fpos_s,
                                        pr_s, pc_s, lane, mW, Q, m, n, cw,
                                        r_star, fcap);
        if (piv1 >= 0) mark_used(used, g, piv1);
      } else if (!windowed) {
        publish(wk, kRescan, 0, lane, nxt);
      } else {
        // the window t + 1 .. t + kWindow (lane (j, g): column t + 1 + j,
        // words g, g + 4, ...) from win: clear it, test its columns for the
        // next pivot, record the free ones, publish the next step and its
        // pivot column
        const int c = t + 1 + (lane >> 2);
        const bool in = c < n;
        uint32_t x[kWl], y[kWl];
#pragma unroll
        for (int i = 0; i < kWl; ++i) {
          const int w = g + 4 * i;
          x[i] = w < mW ? wv[(lane >> 2) * mW + w] : 0u;
          y[i] = w < mW ? pv[w] : 0u;
        }
        // bit piv of the lane's column: word pw is lane (j, pw & 3)'s (every
        // lane joins the shuffle, those past n too)
        uint32_t xp = 0u;
#pragma unroll
        for (int i = 0; i < kWl; ++i) {
          if (g + 4 * i == pw) xp = x[i];
        }
        xp = __shfl_sync(kAll, xp, (lane & ~3) | (pw & 3));
        const bool set = in && (xp & pbit);
        int fw = kNone;    // the lane's first word with a row outside U
        uint32_t fx = 0u;  // that word's bits outside U
#pragma unroll
        for (int i = 0; i < kWl; ++i) {
          const int w = g + 4 * i;
          if (w == pw) y[i] &= ~pbit;
          if (set) x[i] ^= y[i];
          const uint32_t free_bits = x[i] & ~used[i];
          if (fw == kNone && free_bits) {
            fw = w;
            fx = free_bits;
          }
        }
        const bool may = wk.rank < r_star && in;
        const unsigned key = may && fw != kNone
                                 ? (unsigned)(((lane >> 2) << 10) | fw) : ~0u;
        const unsigned best = __reduce_min_sync(kAll, key);
        const int jc = best != ~0u ? (int)(best >> 10) : kWindow;
        if (wk.fcnt < fcap) {
          record_free(wk, t + 1, min(jc, n - t - 1), lane, fcap, fpos_s);
        }
        if (best != ~0u) {
          const int w1 = (int)(best & 1023u);
          const uint32_t fx1 = __shfl_sync(kAll, fx, (jc << 2) + (w1 & 3));
          const int piv1 = (w1 << 5) + __ffs(fx1) - 1;
          publish_pivot(wk, t + 1 + jc, piv1, lane, U, nxt, pr_s, pc_s,
                        false);
          mark_used(used, g, piv1);
          if ((lane >> 2) == jc) {  // the next step's pivot column
#pragma unroll
            for (int i = 0; i < kWl; ++i) {
              if (g + 4 * i < mW) pnxt[g + 4 * i] = x[i];
            }
          }
        } else {
          wk.t0 = min(t + 1 + kWindow, n);
          publish(wk, wk.t0 < n && (wk.rank < r_star || wk.fcnt < fcap)
                          ? kRescan : kDone, 0, lane, nxt);
        }
      }
    } else if (t >= 0) {
      // T's columns 0..m, (warp - 1) + nw1 * (lane + 32 k) a warp: as
      // kGlobal's columns right of the window
      if (mW <= 32) {
        uint32_t ct = sub < 32 ? pv[wl] : 0u;
        if (wl == pw) ct &= ~pbit;
        for (int base = warp - 1; base <= m; base += nw1 << 5) {
          const int c = base + nw1 * lane;
          unsigned hit = __ballot_sync(kAll, c <= m && (T[pw * Q + c] & pbit));
          while (hit) {
            if (sub < 32 && ct) {
              unsigned h = hit;
              for (int k = 0; k < sub && h; ++k) h &= h - 1u;
              if (h) T[wl * Q + base + nw1 * (__ffs(h) - 1)] ^= ct;
            }
            for (int k = 0; k < G && hit; ++k) hit &= hit - 1u;
          }
        }
      } else {
        for (int base = warp - 1; base <= m; base += nw1 << 5) {
          const int c = base + nw1 * lane;
          unsigned hit = __ballot_sync(kAll, c <= m && (T[pw * Q + c] & pbit));
          while (hit) {
            const int cc = base + nw1 * (__ffs(hit) - 1);
            hit &= hit - 1u;
            for (int w = lane; w < mW; w += 32) {
              uint32_t x = pv[w];
              if (w == pw) x &= ~pbit;
              if (x) T[w * Q + cc] ^= x;
            }
          }
        }
      }
    }
    // the next step published, every update of T done: warps 1.. gather
    // its window from T, a word a lane
    __syncthreads();
    const int t1 = reinterpret_cast<const int2*>(nxt)->x;
    if (warp > 0 && windowed && t1 >= 0) {
      uint32_t* wn = win + par * kWindow * mW;
      for (int e = tid - 32; e < kWindow * mW; e += nt - 32) {
        const int j = e / mW;
        const int w = e - j * mW;
        const int c = t1 + 1 + j;
        wn[e] = c < n ? gather_word(T, rows_s,
                                    rows4(rows_s, n, cw, m, c, true), n, cw,
                                    Q, c, w)
                      : 0u;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    counts[0] = wk.rank;
    counts[1] = wk.fcnt;
  }
  __syncthreads();
  const int n_piv = counts[0];
  const int n_free = counts[1];

  for (int k = tid; k < n_piv; k += nt) {
    pr[k * sB + b] = pr_s[k];
    pc[k * sB + b] = pc_s[k];
  }
  for (int k = tid; k < n_free; k += nt) fpos[k * sB + b] = fpos_s[k];
  for (int r = tid; r < m; r += nt) {
    synd_out[r * sB + b] = (int32_t)((T[(r >> 5) * Q + m] >> (r & 31)) & 1u);
  }
  if (fcap > 0) {
    // the free panel: word w of free column k (lane k), transposed
    for (int w = warp; w < mW; w += nw) {
      const int c = lane < n_free ? fpos_s[lane] : 0;
      const uint32_t x = lane < n_free
          ? gather_word(T, rows_s, rows4(rows_s, n, cw, m, c, true), n, cw, Q,
                        c, w) : 0u;
      const uint32_t row = ballot_transpose(x, lane);
      const int r = (w << 5) + lane;
      if (r < m) fword_out[r * sB + b] = (int32_t)row;
    }
  }
  if (kMode == kFull) {
    const int W = (n + 31) >> 5;
    for (int tile = warp; tile < W * mW; tile += nw) {
      const int wc = tile / mW;
      const int rw = tile - wc * mW;
      const int c = (wc << 5) + lane;
      const uint32_t x = c < n ? gather_word(T, rows_s,
                                             rows4(rows_s, n, cw, m, c, true),
                                             n, cw, Q, c, rw) : 0u;
      const uint32_t row = ballot_transpose(x, lane);
      const int r = (rw << 5) + lane;
      if (r < m) packed_out[((size_t)wc * m + r) * sB + b] = (int32_t)row;
    }
  }
}

template <int kMode, int kWl, bool kGlobal, bool kTransform>
__global__ void __launch_bounds__(kMaxThreads, 1)
osd_elim_kernel(const int32_t* __restrict__ colpack,  // (n, mW)
                const int64_t* __restrict__ perm,     // (B, n)
                const int32_t* __restrict__ synd_in,  // (m, B)
                int32_t* __restrict__ synd_out,       // (m, B)
                int32_t* __restrict__ pr,             // (r*, B) zeroed
                int32_t* __restrict__ pc,             // (r*, B) zeroed
                int32_t* __restrict__ fword_out,      // (m, B); fcap > 0 only
                int32_t* __restrict__ fpos,           // (32, B) zeroed; not kPercol
                int32_t* __restrict__ packed_out,     // (W, m, B); not kSkip
                int32_t* __restrict__ ip,             // (n, B) zeroed; kPercol
                int m, int n, int r_star, int fcap, int B,
                uint32_t* scratch,                  // (B, mW, P); kGlobal
                const int16_t* __restrict__ rows,   // (n, cw); kTransform
                int cw) {
  extern __shared__ uint32_t smem[];
  if constexpr (kTransform) {
    elim_transform<kMode, kWl>(smem, perm, synd_in, synd_out, pr, pc,
                               fword_out, fpos, packed_out, m, n, r_star, fcap,
                               B, rows, cw);
    return;
  }
  const int mW = (m + 31) >> 5;
  const int P = (n + 1) | 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nt = blockDim.x;
  const int nw = nt >> 5;
  // (mW, P): columns, syndrome at n
  uint32_t* A = kGlobal ? scratch + (size_t)blockIdx.x * mW * P : smem;
  uint32_t* U = kGlobal ? smem : A + (size_t)mW * P;  // (mW): used rows
  int* slot = (int*)(U + mW);              // (2, 2): pivot column and row
  int* counts = slot + 4;                  // (2): pivots, free columns
  int* fpos_s = counts + 2;                // (32): free columns
  int* pr_s = fpos_s + 32;                 // (m): pivot rows
  int* pc_s = pr_s + m;                    // (m): pivot columns
  const int b = blockIdx.x;
  const size_t sB = (size_t)B;

  const int64_t* perm_b = perm + (size_t)b * n;
  for (int c = tid; c < n; c += nt) {
    const int32_t* src = colpack + (size_t)perm_b[c] * mW;
    for (int w = 0; w < mW; ++w) A[w * P + c] = (uint32_t)src[w];
  }
  for (int w = warp; w < mW; w += nw) {
    const int r = (w << 5) + lane;
    const unsigned bits = __ballot_sync(kAll, r < m && (synd_in[r * sB + b] & 1));
    if (lane == 0) A[w * P + n] = bits;
  }
  for (int i = tid; i < mW; i += nt) U[i] = 0u;
  __syncthreads();

  Walk wk{0, 0, 0, make_int2(kDone, 0)};
  const int g = lane & 3;
  uint32_t used[kWl] = {};  // warp 0's used rows, its words
  if (warp == 0) {
    const int piv0 = scan(wk, A, U, slot, fpos_s, pr_s, pc_s, lane, mW, P, n,
                          r_star, fcap);
    if (piv0 >= 0) mark_used(used, g, piv0);
  }
  __syncthreads();

  // warps 1.. : a lane's share of a set column's words (mW <= 32): word `wl`
  // of the sub-th set column of each G; lanes past G * mW take none
  const int G = mW <= 32 ? 32 / mW : 1;
  const int sub = mW <= 32 && lane < G * mW ? lane / mW : 32;
  const int wl = mW <= 32 ? lane - (lane / mW) * mW : 0;
  const int nw1 = nw - 1;
  int par = 0;
  const bool windowed = mW <= 4 * kWl;
  for (;;) {
    // warp 0 knows what it published; the others read it
    const int2 step = warp == 0 ? wk.out
                                : *reinterpret_cast<const int2*>(slot + 2 * par);
    const int t = step.x;
    if (t == kDone) break;
    par ^= 1;
    int* nxt = slot + 2 * par;
    if (t == kRescan) {
      if (warp == 0) {
        if (windowed) {  // U from the window lanes' words
#pragma unroll
          for (int i = 0; i < kWl; ++i) {
            if (lane < 4 && lane + 4 * i < mW) U[lane + 4 * i] = used[i];
          }
          __syncwarp();
        }
        const int piv1 = scan(wk, A, U, nxt, fpos_s, pr_s, pc_s, lane, mW, P,
                              n, r_star, fcap);
        if (piv1 >= 0) mark_used(used, g, piv1);
      }
      __syncthreads();
      continue;
    }
    const int piv = step.y;
    const int pw = piv >> 5;
    const uint32_t pbit = 1u << (piv & 31);
    const int first = t + 1 + (windowed ? kWindow : 0);  // the others' first
    if (warp == 0 && !windowed) {
      publish(wk, kRescan, 0, lane, nxt);
    } else if (warp == 0) {
      // the window t + 1 .. t + kWindow: clear it (lane (j, g): column
      // t + 1 + j, words g, g + 4, ...; the syndrome included), test its
      // columns for the next pivot as they come out, record the free ones,
      // and publish the next step
      const int c = t + 1 + (lane >> 2);
      const bool in = c <= n;
      const bool set = in && (A[pw * P + c] & pbit);
      // all of the lane's loads first: nothing they read is written here
      uint32_t x[kWl], y[kWl];
#pragma unroll
      for (int i = 0; i < kWl; ++i) {
        const int w = g + 4 * i;
        x[i] = in && w < mW ? A[w * P + c] : 0u;
        y[i] = w < mW ? A[w * P + t] : 0u;
      }
      int fw = kNone;    // the lane's first word with a row outside U
      uint32_t fx = 0u;  // that word's bits outside U
#pragma unroll
      for (int i = 0; i < kWl; ++i) {
        const int w = g + 4 * i;
        if (w == pw) y[i] &= ~pbit;
        if (set) x[i] ^= y[i];
        if (set && w < mW) A[w * P + c] = x[i];
        const uint32_t free_bits = x[i] & ~used[i];
        if (fw == kNone && free_bits) {
          fw = w;
          fx = free_bits;
        }
      }
      // the first column with such a word, and its first such word
      const bool may = wk.rank < r_star && c < n;
      const unsigned key = may && fw != kNone
                               ? (unsigned)(((lane >> 2) << 10) | fw) : ~0u;
      const unsigned best = __reduce_min_sync(kAll, key);
      const int jc = best != ~0u ? (int)(best >> 10) : kWindow;
      if (wk.fcnt < fcap) {
        record_free(wk, t + 1, min(jc, n - t - 1), lane, fcap, fpos_s);
      }
      if (best != ~0u) {
        const int w1 = (int)(best & 1023u);
        const uint32_t fx1 = __shfl_sync(kAll, fx, (jc << 2) + (w1 & 3));
        const int piv1 = (w1 << 5) + __ffs(fx1) - 1;
        publish_pivot(wk, t + 1 + jc, piv1, lane, U, nxt, pr_s, pc_s, false);
        mark_used(used, g, piv1);
      } else {
        wk.t0 = min(t + 1 + kWindow, n);
        publish(wk, wk.t0 < n && (wk.rank < r_star || wk.fcnt < fcap)
                        ? kRescan : kDone, 0, lane, nxt);
      }
    } else if (mW <= 32) {
      // columns first + (warp - 1) + nw1 * (lane + 32 k): a lane tests its
      // column's bit at the pivot row; then the lanes XOR the pivot column
      // (without its pivot bit) into the set ones, G columns at a time
      uint32_t ct = sub < 32 ? A[wl * P + t] : 0u;
      if (wl == pw) ct &= ~pbit;
      for (int base = first + warp - 1; base <= n; base += nw1 << 5) {
        const int c = base + nw1 * lane;
        unsigned hit = __ballot_sync(kAll, c <= n && (A[pw * P + c] & pbit));
        while (hit) {
          if (sub < 32 && ct) {
            unsigned h = hit;
            for (int k = 0; k < sub && h; ++k) h &= h - 1u;
            if (h) A[wl * P + base + nw1 * (__ffs(h) - 1)] ^= ct;
          }
          for (int k = 0; k < G && hit; ++k) hit &= hit - 1u;
        }
      }
    } else {
      for (int base = first + warp - 1; base <= n; base += nw1 << 5) {
        const int c = base + nw1 * lane;
        unsigned hit = __ballot_sync(kAll, c <= n && (A[pw * P + c] & pbit));
        while (hit) {
          const int cc = base + nw1 * (__ffs(hit) - 1);
          hit &= hit - 1u;
          for (int w = lane; w < mW; w += 32) {
            uint32_t x = A[w * P + t];
            if (w == pw) x &= ~pbit;
            if (x) A[w * P + cc] ^= x;
          }
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    counts[0] = wk.rank;
    counts[1] = wk.fcnt;
  }
  __syncthreads();
  const int n_piv = counts[0];
  const int n_free = counts[1];

  for (int k = tid; k < n_piv; k += nt) {
    pr[k * sB + b] = pr_s[k];
    pc[k * sB + b] = pc_s[k];
    if (kMode == kPercol) ip[pc_s[k] * sB + b] = 1;
  }
  if (kMode != kPercol) {
    for (int k = tid; k < n_free; k += nt) fpos[k * sB + b] = fpos_s[k];
  }

  for (int r = tid; r < m; r += nt) {
    const int w = r >> 5;
    const int j = r & 31;
    synd_out[r * sB + b] = (int32_t)((A[w * P + n] >> j) & 1u);
    if (kMode != kPercol && fcap > 0) {
      uint32_t f = 0;
      for (int k = 0; k < n_free; ++k) {
        f |= ((A[w * P + fpos_s[k]] >> j) & 1u) << k;
      }
      fword_out[r * sB + b] = (int32_t)f;
    }
  }
  if (kMode != kSkip) {
    // pivot columns become their unit vectors
    for (int k = tid; k < n_piv; k += nt) {
      const int c = pc_s[k];
      const int r = pr_s[k];
      for (int w = 0; w < mW; ++w) {
        A[w * P + c] = w == (r >> 5) ? 1u << (r & 31) : 0u;
      }
    }
    __syncthreads();
    const int W = (n + 31) >> 5;
    for (int tile = warp; tile < W * mW; tile += nw) {
      const int wc = tile / mW;
      const int rw = tile - wc * mW;
      const int c = (wc << 5) + lane;
      const uint32_t x = c < n ? A[rw * P + c] : 0u;
      const uint32_t row = ballot_transpose(x, lane);
      const int r = (rw << 5) + lane;
      if (r < m) packed_out[((size_t)wc * m + r) * sB + b] = (int32_t)row;
    }
  }
}

// the window's words a lane for mW words a column: 1, 2, 3, 4, 6 or 8, and
// 1 (no window) past 32
inline int window_words(int mW) {
  const int need = (mW + 3) / 4;
  return need <= 4 ? need : need <= 6 ? 6 : need <= 8 ? 8 : 1;
}

// where a shot's matrix lives: in the block's shared memory, in a device
// scratch (kGlobal), or as its row transform in shared memory (kTransform)
enum Memory { kShared = 0, kDevice = 1, kTransformMem = 2 };

// the transform mode's shared memory (ops/osd_device.py
// elim_transform_bytes): T, U, pcol, win, the walk's state, the pivots and
// the columns' rows
inline long transform_bytes(int m, int n, int cw) {
  const long mW = (m + 31) >> 5;
  return 4 * (mW * (((m + 2) | 1) + 3 + 2 * kWindow) + 6 + 32 + 2L * m) +
         4 * (((long)cw * n + 1) / 2);
}

template <int kMode, int kWl, bool kGlobal, bool kTransform>
int set_smem(int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      osd_elim_kernel<kMode, kWl, kGlobal, kTransform>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <int kMode, int kWl, bool kGlobal, bool kTransform>
int launch_mem(const int32_t* colpack, const int64_t* perm,
               const int32_t* synd_in, int32_t* synd_out, int32_t* pr,
               int32_t* pc, int32_t* fword, int32_t* fpos,
               int32_t* packed_out, int32_t* ip, int m, int n, int r_star,
               int fcap, int B, int threads, int smem_bytes,
               uint32_t* scratch, const int16_t* rows, int cw, void* stream) {
  const int e = set_smem<kMode, kWl, kGlobal, kTransform>(smem_bytes);
  if (e != 0) return e;
  osd_elim_kernel<kMode, kWl, kGlobal, kTransform>
      <<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
          colpack, perm, synd_in, synd_out, pr, pc, fword, fpos, packed_out,
          ip, m, n, r_star, fcap, B, scratch, rows, cw);
  return (int)cudaGetLastError();
}

// the shared-memory mode; with a scratch tensor the device-memory mode;
// with row lists the transform mode (not kPercol)
template <int kMode, int kWl>
int launch_wl(const int32_t* colpack, const int64_t* perm,
              const int32_t* synd_in, int32_t* synd_out, int32_t* pr,
              int32_t* pc, int32_t* fword, int32_t* fpos, int32_t* packed_out,
              int32_t* ip, int m, int n, int r_star, int fcap, int B,
              int threads, int smem_bytes, uint32_t* scratch,
              const int16_t* rows, int cw, void* stream) {
  if (rows != nullptr) {
    if constexpr (kMode == kPercol) {
      return (int)cudaErrorInvalidValue;
    } else {
      if (cw < 1 || m > 65534 || smem_bytes < transform_bytes(m, n, cw)) {
        return (int)cudaErrorInvalidValue;
      }
      return launch_mem<kMode, kWl, false, true>(
          colpack, perm, synd_in, synd_out, pr, pc, fword, fpos, packed_out,
          ip, m, n, r_star, fcap, B, threads, smem_bytes, nullptr, rows, cw,
          stream);
    }
  }
  return scratch != nullptr
             ? launch_mem<kMode, kWl, true, false>(
                   colpack, perm, synd_in, synd_out, pr, pc, fword, fpos,
                   packed_out, ip, m, n, r_star, fcap, B, threads, smem_bytes,
                   scratch, nullptr, 0, stream)
             : launch_mem<kMode, kWl, false, false>(
                   colpack, perm, synd_in, synd_out, pr, pc, fword, fpos,
                   packed_out, ip, m, n, r_star, fcap, B, threads, smem_bytes,
                   nullptr, nullptr, 0, stream);
}

template <int kMode>
int launch(const int32_t* colpack, const int64_t* perm, const int32_t* synd_in,
           int32_t* synd_out, int32_t* pr, int32_t* pc, int32_t* fword,
           int32_t* fpos, int32_t* packed_out, int32_t* ip, int m, int n,
           int r_star, int fcap, int B, int threads, int smem_bytes,
           uint32_t* scratch, const int16_t* rows, int cw, void* stream) {
  // warp 0 walks and clears the columns after the pivot, the others the
  // rest: a block has two warps at least
  if (threads < 64 || threads % 32) return (int)cudaErrorInvalidValue;
#define OSD_ELIM_LAUNCH(WL)                                                   \
  return launch_wl<kMode, WL>(colpack, perm, synd_in, synd_out, pr, pc,       \
                              fword, fpos, packed_out, ip, m, n, r_star,      \
                              fcap, B, threads, smem_bytes, scratch, rows,    \
                              cw, stream)
  switch (window_words((m + 31) >> 5)) {
    case 2: OSD_ELIM_LAUNCH(2);
    case 3: OSD_ELIM_LAUNCH(3);
    case 4: OSD_ELIM_LAUNCH(4);
    case 6: OSD_ELIM_LAUNCH(6);
    case 8: OSD_ELIM_LAUNCH(8);
    default: OSD_ELIM_LAUNCH(1);
  }
#undef OSD_ELIM_LAUNCH
}

template <int kMode, int kWl, bool kGlobal, bool kTransform>
int resident_mem(int threads, int smem_bytes, int* blocks) {
  const int e = set_smem<kMode, kWl, kGlobal, kTransform>(smem_bytes);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, osd_elim_kernel<kMode, kWl, kGlobal, kTransform>, threads,
      smem_bytes);
}

template <int kMode, int kWl>
int resident_wl(int threads, int smem_bytes, int memory, int* blocks) {
  if (memory == kTransformMem) {
    if constexpr (kMode == kPercol) {
      return (int)cudaErrorInvalidValue;
    } else {
      return resident_mem<kMode, kWl, false, true>(threads, smem_bytes,
                                                   blocks);
    }
  }
  return memory == kDevice
             ? resident_mem<kMode, kWl, true, false>(threads, smem_bytes, blocks)
             : resident_mem<kMode, kWl, false, false>(threads, smem_bytes,
                                                      blocks);
}

template <int kMode>
int resident(int m, int threads, int smem_bytes, int memory, int* blocks) {
  switch (window_words((m + 31) >> 5)) {
    case 2: return resident_wl<kMode, 2>(threads, smem_bytes, memory, blocks);
    case 3: return resident_wl<kMode, 3>(threads, smem_bytes, memory, blocks);
    case 4: return resident_wl<kMode, 4>(threads, smem_bytes, memory, blocks);
    case 6: return resident_wl<kMode, 6>(threads, smem_bytes, memory, blocks);
    case 8: return resident_wl<kMode, 8>(threads, smem_bytes, memory, blocks);
    default: return resident_wl<kMode, 1>(threads, smem_bytes, memory, blocks);
  }
}

}  // namespace

// rows (n, cw) int16, each column's rows (-1 past its weight), selects the
// transform mode; else scratch the device-memory mode; else shared memory
extern "C" int osd_elim_launch(const int32_t* colpack, const int64_t* perm,
                               const int32_t* synd_in, int32_t* synd_out,
                               int32_t* pr, int32_t* pc, int32_t* fword,
                               int32_t* fpos, int m, int n, int r_star,
                               int fcap, int B, int threads, int smem_bytes,
                               uint32_t* scratch, const int16_t* rows, int cw,
                               void* stream) {
  return launch<kSkip>(colpack, perm, synd_in, synd_out, pr, pc, fword, fpos,
                       nullptr, nullptr, m, n, r_star, fcap, B, threads,
                       smem_bytes, scratch, rows, cw, stream);
}

extern "C" int osd_elim_full_launch(const int32_t* colpack,
                                    const int64_t* perm,
                                    const int32_t* synd_in, int32_t* synd_out,
                                    int32_t* pr, int32_t* pc, int32_t* fword,
                                    int32_t* fpos, int32_t* packed_out, int m,
                                    int n, int r_star, int fcap, int B,
                                    int threads, int smem_bytes,
                                    uint32_t* scratch, const int16_t* rows,
                                    int cw, void* stream) {
  return launch<kFull>(colpack, perm, synd_in, synd_out, pr, pc, fword, fpos,
                       packed_out, nullptr, m, n, r_star, fcap, B, threads,
                       smem_bytes, scratch, rows, cw, stream);
}

extern "C" int osd_elim_percol_launch(const int32_t* colpack,
                                      const int64_t* perm,
                                      const int32_t* synd_in,
                                      int32_t* synd_out, int32_t* pr,
                                      int32_t* pc, int32_t* ip,
                                      int32_t* packed_out, int m, int n,
                                      int r_star, int B, int threads,
                                      int smem_bytes, uint32_t* scratch,
                                      const int16_t* rows, int cw,
                                      void* stream) {
  return launch<kPercol>(colpack, perm, synd_in, synd_out, pr, pc, nullptr,
                         nullptr, packed_out, ip, m, n, r_star, 0, B, threads,
                         smem_bytes, scratch, rows, cw, stream);
}

// blocks of mode `mode` in memory `memory` (0 shared, 1 device, 2 transform)
// for m rows with `threads` threads and `smem_bytes` of shared memory that
// one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
extern "C" int osd_elim_resident(int mode, int m, int threads, int smem_bytes,
                                 int memory, int* blocks) {
  return mode == kSkip
             ? resident<kSkip>(m, threads, smem_bytes, memory, blocks)
         : mode == kFull
             ? resident<kFull>(m, threads, smem_bytes, memory, blocks)
             : resident<kPercol>(m, threads, smem_bytes, memory, blocks);
}
