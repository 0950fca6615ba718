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
// Bound: integer word operations on shared memory.  A pivot step tests one
// word of each column right of t and XORs the pivot column's words into the
// set ones; ops/osd_device.py elimination_work counts the row-wise walk's
// operations per run, which chip_smoke.py takes for the operations bound.
// Device memory sees the permutation, the syndromes and colpack read once
// and each output word written once.
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

template <int kMode, int kWl, bool kGlobal>
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
                uint32_t* scratch) {               // (B, mW, P); kGlobal
  extern __shared__ uint32_t smem[];
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

template <int kMode, int kWl, bool kGlobal>
int set_smem(int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(osd_elim_kernel<kMode, kWl, kGlobal>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

template <int kMode, int kWl, bool kGlobal>
int launch_mem(const int32_t* colpack, const int64_t* perm,
               const int32_t* synd_in, int32_t* synd_out, int32_t* pr,
               int32_t* pc, int32_t* fword, int32_t* fpos,
               int32_t* packed_out, int32_t* ip, int m, int n, int r_star,
               int fcap, int B, int threads, int smem_bytes,
               uint32_t* scratch, void* stream) {
  const int e = set_smem<kMode, kWl, kGlobal>(smem_bytes);
  if (e != 0) return e;
  osd_elim_kernel<kMode, kWl, kGlobal>
      <<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
          colpack, perm, synd_in, synd_out, pr, pc, fword, fpos, packed_out,
          ip, m, n, r_star, fcap, B, scratch);
  return (int)cudaGetLastError();
}

// the shared-memory mode, or with a scratch tensor the device-memory mode
template <int kMode, int kWl>
int launch_wl(const int32_t* colpack, const int64_t* perm,
              const int32_t* synd_in, int32_t* synd_out, int32_t* pr,
              int32_t* pc, int32_t* fword, int32_t* fpos, int32_t* packed_out,
              int32_t* ip, int m, int n, int r_star, int fcap, int B,
              int threads, int smem_bytes, uint32_t* scratch, void* stream) {
  return scratch != nullptr
             ? launch_mem<kMode, kWl, true>(
                   colpack, perm, synd_in, synd_out, pr, pc, fword, fpos,
                   packed_out, ip, m, n, r_star, fcap, B, threads, smem_bytes,
                   scratch, stream)
             : launch_mem<kMode, kWl, false>(
                   colpack, perm, synd_in, synd_out, pr, pc, fword, fpos,
                   packed_out, ip, m, n, r_star, fcap, B, threads, smem_bytes,
                   nullptr, stream);
}

template <int kMode>
int launch(const int32_t* colpack, const int64_t* perm, const int32_t* synd_in,
           int32_t* synd_out, int32_t* pr, int32_t* pc, int32_t* fword,
           int32_t* fpos, int32_t* packed_out, int32_t* ip, int m, int n,
           int r_star, int fcap, int B, int threads, int smem_bytes,
           uint32_t* scratch, void* stream) {
  // warp 0 walks and clears the columns after the pivot, the others the
  // rest: a block has two warps at least
  if (threads < 64 || threads % 32) return (int)cudaErrorInvalidValue;
#define OSD_ELIM_LAUNCH(WL)                                                   \
  return launch_wl<kMode, WL>(colpack, perm, synd_in, synd_out, pr, pc,       \
                              fword, fpos, packed_out, ip, m, n, r_star,      \
                              fcap, B, threads, smem_bytes, scratch, stream)
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

template <int kMode, int kWl, bool kGlobal>
int resident_mem(int threads, int smem_bytes, int* blocks) {
  const int e = set_smem<kMode, kWl, kGlobal>(smem_bytes);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, osd_elim_kernel<kMode, kWl, kGlobal>, threads, smem_bytes);
}

template <int kMode, int kWl>
int resident_wl(int threads, int smem_bytes, int global, int* blocks) {
  return global ? resident_mem<kMode, kWl, true>(threads, smem_bytes, blocks)
                : resident_mem<kMode, kWl, false>(threads, smem_bytes, blocks);
}

template <int kMode>
int resident(int m, int threads, int smem_bytes, int global, int* blocks) {
  switch (window_words((m + 31) >> 5)) {
    case 2: return resident_wl<kMode, 2>(threads, smem_bytes, global, blocks);
    case 3: return resident_wl<kMode, 3>(threads, smem_bytes, global, blocks);
    case 4: return resident_wl<kMode, 4>(threads, smem_bytes, global, blocks);
    case 6: return resident_wl<kMode, 6>(threads, smem_bytes, global, blocks);
    case 8: return resident_wl<kMode, 8>(threads, smem_bytes, global, blocks);
    default: return resident_wl<kMode, 1>(threads, smem_bytes, global, blocks);
  }
}

}  // namespace

extern "C" int osd_elim_launch(const int32_t* colpack, const int64_t* perm,
                               const int32_t* synd_in, int32_t* synd_out,
                               int32_t* pr, int32_t* pc, int32_t* fword,
                               int32_t* fpos, int m, int n, int r_star,
                               int fcap, int B, int threads, int smem_bytes,
                               uint32_t* scratch, void* stream) {
  return launch<kSkip>(colpack, perm, synd_in, synd_out, pr, pc, fword, fpos,
                       nullptr, nullptr, m, n, r_star, fcap, B, threads,
                       smem_bytes, scratch, stream);
}

extern "C" int osd_elim_full_launch(const int32_t* colpack,
                                    const int64_t* perm,
                                    const int32_t* synd_in, int32_t* synd_out,
                                    int32_t* pr, int32_t* pc, int32_t* fword,
                                    int32_t* fpos, int32_t* packed_out, int m,
                                    int n, int r_star, int fcap, int B,
                                    int threads, int smem_bytes,
                                    uint32_t* scratch, void* stream) {
  return launch<kFull>(colpack, perm, synd_in, synd_out, pr, pc, fword, fpos,
                       packed_out, nullptr, m, n, r_star, fcap, B, threads,
                       smem_bytes, scratch, stream);
}

extern "C" int osd_elim_percol_launch(const int32_t* colpack,
                                      const int64_t* perm,
                                      const int32_t* synd_in,
                                      int32_t* synd_out, int32_t* pr,
                                      int32_t* pc, int32_t* ip,
                                      int32_t* packed_out, int m, int n,
                                      int r_star, int B, int threads,
                                      int smem_bytes, uint32_t* scratch,
                                      void* stream) {
  return launch<kPercol>(colpack, perm, synd_in, synd_out, pr, pc, nullptr,
                         nullptr, packed_out, ip, m, n, r_star, 0, B, threads,
                         smem_bytes, scratch, stream);
}

// blocks of mode `mode` (in device memory when `global`) for m rows with
// `threads` threads and `smem_bytes` of shared memory that one SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
extern "C" int osd_elim_resident(int mode, int m, int threads, int smem_bytes,
                                 int global, int* blocks) {
  return mode == kSkip
             ? resident<kSkip>(m, threads, smem_bytes, global, blocks)
         : mode == kFull
             ? resident<kFull>(m, threads, smem_bytes, global, blocks)
             : resident<kPercol>(m, threads, smem_bytes, global, blocks);
}
