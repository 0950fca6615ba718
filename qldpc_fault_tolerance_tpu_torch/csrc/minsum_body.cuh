// The scaled min-sum decode of one block's shots: the body shared by the
// min-sum kernels (bp_minsum.cu: kernel 1 and the bf16 head) and the
// whole-pipeline fused decode (fused_decode.cu), so all run one copy of the
// arithmetic.
//
// Function: ops/bp.py bp_decode(method="minimum_sum") for the block's
// `lanes` shots: per-check top-2 minimum and sign product (with the syndrome
// sign), scaled check-to-variable messages, variable totals, v2c = total -
// own c2v, hard decision, parity against the syndrome.  Each shot freezes at
// its first convergence; a converged shot does no further work, which is
// exact because its outputs are frozen either way.  The caller builds with
// -fmad=false so the arithmetic rounds like the plain PyTorch versions
// (ops/bp_kernel.py).
//
// Two message formats, a template parameter:
//   F32Msg  (kernel 1, minsum_plain): float32 v2c; a variable's total is
//           llr0 + (its c2v summed in the order of its list);
//   Bf16Msg (the bf16 head and the fused decode's bf16 mode,
//           minsum_dense_plain, the JAX package's _minsum_plane_loop): bf16
//           v2c; the total starts from llr0 and adds, slot after slot, the
//           float32 sum of that slot's bf16-rounded c2v in list order (the
//           caller passes variable lists sorted by slot, then check:
//           ops/bp_kernel.py slot_ordered_graph, or SlotPlanes below);
//           v2c = bf16(bf16(total) - c2v) and parity reads bf16(total).
// c2v is float32 in both.
//
// Layout: messages edge-major and shot-minor (v2c and c2v at
// [e * lanes + lane]), hard decisions at [j * lanes + lane], all in shared
// memory.  A hard-decision byte holds total < 0 in bit 0 and the sign the
// parity pass reads in bit 1 (the same bit for F32Msg).  Thread t works for
// shot t % lanes on row t / lanes; the rows split the checks and the
// variables between barriers.  Every thread of the block must call decode():
// it synchronises the block.
//
// The graph, a second template parameter, numbers the edges and lists them:
//   Graph      (ops/bp.py TannerGraph): check-major, edge i * rw + s;
//   SlotPlanes (ops/bp_kernel.py SparseHeadGraph): slot-major index planes,
//              edge s * m + i, each variable's edges in ascending edge
//              order, which is (slot, check) order.
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

// Padded Tanner-graph adjacency (ops/bp.py TannerGraph), in device memory.
struct Graph {
  const int32_t* chk_nbr;   // (m, rw)
  const uint8_t* chk_mask;  // (m, rw)
  const int32_t* var_nbr;   // (n, cw)
  const int32_t* var_slot;  // (n, cw)
  const uint8_t* var_mask;  // (n, cw)
  int m, n, rw, cw;
  __device__ int edge(int i, int s) const { return i * rw + s; }
  __device__ bool live(int e) const { return chk_mask[e] != 0; }
  __device__ int var(int e) const { return chk_nbr[e]; }
  // variable j's t-th edge e and its check slot s, false for padding
  __device__ bool term(int j, int t, int& e, int& s) const {
    const int q = j * cw + t;
    if (!var_mask[q]) return false;
    s = var_slot[q];
    e = var_nbr[q] * rw + s;
    return true;
  }
};

// Slot-major index planes of a BP head (ops/bp_kernel.py SparseHeadGraph),
// in device memory.
struct SlotPlanes {
  const int32_t* chk_idx;   // (rw, m): variable of check i's slot-s edge
  const float* mask;        // (rw, m): 1.0 real edge, 0.0 padding
  const int32_t* var_edge;  // (n, cw): edges s * m + i ascending, -1 pads
  int m, n, rw, cw;
  float inv_m;              // float32(1 / m)
  __device__ int edge(int i, int s) const { return s * m + i; }
  __device__ bool live(int e) const { return mask[e] > 0.f; }
  __device__ int var(int e) const { return chk_idx[e]; }
  // the slot e / m: a float quotient, off by at most one for e < 2^24 (a
  // block's shared memory holds far fewer edges), then corrected; in place
  // of an integer division per term
  __device__ bool term(int j, int t, int& e, int& s) const {
    e = var_edge[j * cw + t];
    if (e < 0) return false;
    s = (int)((float)e * inv_m);
    if (s * m > e) {
      --s;
    } else if ((s + 1) * m <= e) {
      ++s;
    }
    return true;
  }
};

// Per-shot decode state in shared memory, one entry per lane.
struct LaneState {
  int* done;   // converged (or not a shot of the batch)
  int* bad;    // parity failed this iteration
  int* iters;  // iteration of first convergence, max_iter if none
};

// Io supplies the shot's syndrome bit synd(i) and channel LLR llr0(j), and
// is told of each variable's start (init_var(j)) and of each hard decision
// and total of a live shot (store_var(j, h, total)).
template <class Msg, class G, class Io>
__device__ void decode(const G& g, Io& io, typename Msg::T* v2c, float* c2v,
                       uint8_t* hard, LaneState st, int lanes, int lane,
                       int row, int rows, bool valid, int max_iter,
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
      v2c[e * lanes + lane] = Msg::store(io.llr0(g.var(e)));
    for (int j = row; j < n; j += rows) {
      hard[j * lanes + lane] = 0;
      io.init_var(j);
    }
  }
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    if (__syncthreads_and(st.done[lane])) break;
    const bool active = !st.done[lane];

    // check pass: streaming top-2 magnitudes and the sign product
    if (active) {
      for (int i = row; i < m; i += rows) {
        float sg = io.synd(i) ? -1.f : 1.f;
        float min1 = kBig, min2 = kBig;
        int amin = 0;
        unsigned negs = 0u;
        for (int s = 0; s < rw; ++s) {
          const int e = g.edge(i, s);
          float mag = kBig;
          if (g.live(e)) {
            const float v = Msg::load(v2c[e * lanes + lane]);
            mag = fabsf(v);
            if (v < 0.f) {
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
        for (int s = 0; s < rw; ++s) {
          const int e = g.edge(i, s);
          float c = 0.f;
          if (g.live(e)) {
            const float ex = fminf(s == amin ? min2 : min1, kBig);
            c = scale * ex;
            if ((sg < 0.f) != (((negs >> s) & 1u) != 0u)) c = -c;
          }
          c2v[e * lanes + lane] = c;
        }
      }
    }
    __syncthreads();

    // variable pass: the totals, then v2c = total - own c2v
    if (active) {
      for (int j = row; j < n; j += rows) {
        float total;
        if constexpr (Msg::kBf16) {
          total = io.llr0(j);
          float part = 0.f;
          int run = -1;  // the slot whose terms `part` sums
          for (int t = 0; t < cw; ++t) {
            int e, s;
            if (!g.term(j, t, e, s)) continue;
            const float c = bf16_round(c2v[e * lanes + lane]);
            if (s == run) {
              part = part + c;
            } else {
              if (run >= 0) total = total + part;
              part = c;
              run = s;
            }
          }
          if (run >= 0) total = total + part;
        } else {
          float acc = 0.f;
          for (int t = 0; t < cw; ++t) {
            int e, s;
            float c = 0.f;
            if (g.term(j, t, e, s)) c = c2v[e * lanes + lane];
            acc = (t == 0) ? c : acc + c;
          }
          total = io.llr0(j) + acc;
        }
        const float t_e = Msg::kBf16 ? bf16_round(total) : total;
        for (int t = 0; t < cw; ++t) {
          int e, s;
          if (g.term(j, t, e, s)) v2c[e * lanes + lane] = Msg::store(t_e - c2v[e * lanes + lane]);
        }
        const uint8_t h = total < 0.f ? 1 : 0;
        hard[j * lanes + lane] = h | (t_e < 0.f ? 2 : 0);
        io.store_var(j, h, total);
      }
    }
    __syncthreads();

    // parity pass: the hard decision must reproduce every syndrome bit
    if (active) {
      for (int i = row; i < m; i += rows) {
        unsigned par = io.synd(i);
        for (int s = 0; s < rw; ++s) {
          const int e = g.edge(i, s);
          if (g.live(e)) par ^= hard[g.var(e) * lanes + lane] >> 1;
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
