// The scaled min-sum arithmetic of one check and of one variable, shared by
// the min-sum kernels (bp_minsum.cu: kernel 1 and the bf16 head) and the
// whole-pipeline fused decode (fused_decode.cu), so all run one copy of it;
// and decode(), the fused decode's loop over a block of shots.
//
// Function: ops/bp.py bp_decode(method="minimum_sum"): per-check top-2
// minimum and sign product (with the syndrome sign), scaled
// check-to-variable messages, variable totals, v2c = total - own c2v, hard
// decision, parity against the syndrome.  The caller builds with
// -fmad=false so the arithmetic rounds like the plain PyTorch versions
// (ops/bp_kernel.py).
//
// Two message formats, a template parameter:
//   F32Msg  (kernel 1, minsum_plain): float32 v2c; a variable's total is
//           llr0 + (its c2v summed in the order of its list, padding adding
//           0);
//   Bf16Msg (the bf16 head and the fused decode's bf16 mode,
//           minsum_dense_plain, the JAX package's _minsum_plane_loop): bf16
//           v2c; the total starts from llr0 and adds, slot after slot, the
//           float32 sum of that slot's bf16-rounded c2v in list order (the
//           caller passes variable lists sorted by slot, then check:
//           ops/bp_kernel.py slot_ordered_graph or minsum_planes); v2c =
//           bf16(bf16(total) - c2v) and parity reads bf16(total).
// c2v is float32 in both.
//
// Bit-exactness: one check's top-2 and sign product are computed by one
// thread in slot order (check_top2), and one variable's total by one thread
// in list order (var_total); no sum is split or reordered.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace minsum {

struct F32Msg {
  using T = float;
  static constexpr bool kBf16 = false;
  __device__ static T store(float x) { return x; }
  __device__ static float load(T x) { return x; }
};

struct Bf16Msg {
  using T = __nv_bfloat16;
  static constexpr bool kBf16 = true;
  __device__ static T store(float x) { return __float2bfloat16_rn(x); }
  __device__ static float load(T x) { return __bfloat162float(x); }
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

constexpr int kMaxLanes = 8;
constexpr float kBig = 1e30f;  // stands in for +inf, as ops/bp.py _BIG

// A check's state after its v2c: the two smallest magnitudes (kBig for
// padding), the slot of the first, each live slot's negative sign as a bit,
// and whether the product of the signs and the syndrome sign is negative.
struct Top2 {
  float min1, min2;
  int amin;
  unsigned negs;
  bool neg;
};

// The streaming top-2 over a check's rw slots in slot order; v(s, x) gives
// slot s's v2c in x and returns false for a padded slot.
template <class V>
__device__ __forceinline__ Top2 check_top2(int rw, bool synd, V v) {
  float sg = synd ? -1.f : 1.f;
  float min1 = kBig, min2 = kBig;
  int amin = 0;
  unsigned negs = 0u;
  for (int s = 0; s < rw; ++s) {
    float x, mag = kBig;
    if (v(s, x)) {
      mag = fabsf(x);
      if (x < 0.f) {
        negs |= 1u << s;
        sg = -sg;
      }
    }
    if (mag < min1) {
      min2 = min1;
      min1 = mag;
      amin = s;
    } else if (mag < min2) {
      min2 = mag;
    }
  }
  return Top2{min1, min2, amin, negs, sg < 0.f};
}

// the scaled c2v of live slot s
__device__ __forceinline__ float check_c2v(const Top2& c, int s, float scale) {
  float r = scale * fminf(s == c.amin ? c.min2 : c.min1, kBig);
  if (c.neg != (((c.negs >> s) & 1u) != 0u)) r = -r;
  return r;
}

// A variable's total from its channel LLR and its cw terms in list order;
// term(t, c, s) gives term t's c2v in c and its check slot in s, and
// returns false for padding.
template <class Msg, class Term>
__device__ __forceinline__ float var_total(float llr0, int cw, Term term) {
  if constexpr (Msg::kBf16) {
    float total = llr0, part = 0.f;
    int run = -1;  // the slot whose terms `part` sums
    for (int t = 0; t < cw; ++t) {
      float c;
      int s;
      if (!term(t, c, s)) continue;
      c = bf16_round(c);
      if (s == run) {
        part = part + c;
      } else {
        if (run >= 0) total = total + part;
        part = c;
        run = s;
      }
    }
    if (run >= 0) total = total + part;
    return total;
  } else {
    float acc = 0.f;
    for (int t = 0; t < cw; ++t) {
      float c;
      int s;
      if (!term(t, c, s)) c = 0.f;
      acc = (t == 0) ? c : acc + c;
    }
    return llr0 + acc;
  }
}

// the total as the v2c and the parity read it
template <class Msg>
__device__ __forceinline__ float gather_total(float total) {
  return Msg::kBf16 ? bf16_round(total) : total;
}

// Padded Tanner-graph adjacency (ops/bp.py TannerGraph), in device memory.
struct Graph {
  const int32_t* chk_nbr;   // (m, rw)
  const uint8_t* chk_mask;  // (m, rw)
  const int32_t* var_nbr;   // (n, cw)
  const int32_t* var_slot;  // (n, cw)
  const uint8_t* var_mask;  // (n, cw)
  int m, n, rw, cw;
};

// Per-shot decode state in shared memory, one entry per lane.
struct LaneState {
  int* done;   // converged (or not a shot of the batch)
  int* bad;    // parity failed this iteration
  int* iters;  // iteration of first convergence, max_iter if none
};

// The fused decode's loop: a block's `lanes` shots in lockstep.  Messages
// are edge-major and shot-minor (v2c and c2v at [e * lanes + lane], edge
// i * rw + s), hard decisions at [j * lanes + lane] (total < 0 in bit 0,
// the sign the parity pass reads in bit 1).  Thread t works for shot
// t % lanes on row t / lanes; the rows split the checks and the variables
// between barriers.  Each shot freezes at its first convergence and does
// no further work; the loop ends when all have.  Io supplies the shot's
// syndrome bit synd(i) and channel LLR llr0(j).  Every thread of the block
// must call decode(): it synchronises the block.
template <class Msg, class Io>
__device__ void decode(const Graph& g, Io& io, typename Msg::T* v2c,
                       float* c2v, uint8_t* hard, LaneState st, int lanes,
                       int lane, int row, int rows, bool valid, int max_iter,
                       float scale) {
  const int m = g.m, n = g.n, rw = g.rw, cw = g.cw;
  const int E = m * rw;
  if (row == 0) {
    st.done[lane] = valid ? 0 : 1;
    st.bad[lane] = 0;
    st.iters[lane] = max_iter;
  }
  if (valid) {
    for (int e = row; e < E; e += rows)
      v2c[e * lanes + lane] = Msg::store(io.llr0(g.chk_nbr[e]));
    for (int j = row; j < n; j += rows) hard[j * lanes + lane] = 0;
  }
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    if (__syncthreads_and(st.done[lane])) break;
    const bool active = !st.done[lane];

    // check pass
    if (active) {
      for (int i = row; i < m; i += rows) {
        const Top2 c = check_top2(rw, io.synd(i), [&](int s, float& x) {
          const int e = i * rw + s;
          if (!g.chk_mask[e]) return false;
          x = Msg::load(v2c[e * lanes + lane]);
          return true;
        });
        for (int s = 0; s < rw; ++s) {
          const int e = i * rw + s;
          c2v[e * lanes + lane] = g.chk_mask[e] ? check_c2v(c, s, scale) : 0.f;
        }
      }
    }
    __syncthreads();

    // variable pass: the totals, then v2c = total - own c2v
    if (active) {
      for (int j = row; j < n; j += rows) {
        const int* nbr = g.var_nbr + j * cw;
        const int* slot = g.var_slot + j * cw;
        const uint8_t* live = g.var_mask + j * cw;
        const float total = var_total<Msg>(io.llr0(j), cw, [&](int t, float& c, int& s) {
          if (!live[t]) return false;
          s = slot[t];
          c = c2v[(nbr[t] * rw + s) * lanes + lane];
          return true;
        });
        const float t_e = gather_total<Msg>(total);
        for (int t = 0; t < cw; ++t) {
          if (!live[t]) continue;
          const int e = nbr[t] * rw + slot[t];
          v2c[e * lanes + lane] = Msg::store(t_e - c2v[e * lanes + lane]);
        }
        hard[j * lanes + lane] = (total < 0.f ? 1 : 0) | (t_e < 0.f ? 2 : 0);
      }
    }
    __syncthreads();

    // parity pass: the hard decision must reproduce every syndrome bit
    if (active) {
      for (int i = row; i < m; i += rows) {
        unsigned par = io.synd(i);
        for (int s = 0; s < rw; ++s) {
          const int e = i * rw + s;
          if (g.chk_mask[e]) par ^= hard[g.chk_nbr[e] * lanes + lane] >> 1;
        }
        if (par & 1u) st.bad[lane] = 1;
      }
    }
    __syncthreads();
    if (row == 0 && active) {
      if (!st.bad[lane]) {
        st.done[lane] = 1;
        st.iters[lane] = it + 1;
      }
      st.bad[lane] = 0;
    }
    __syncthreads();
  }
}

}  // namespace minsum
