// The scaled min-sum decode of one block's shots: the body shared by the
// min-sum kernel (bp_minsum.cu) and the whole-pipeline fused decode
// (fused_decode.cu), so both run one copy of the arithmetic.
//
// Function: ops/bp.py bp_decode(method="minimum_sum") for the block's
// `lanes` shots: per-check top-2 minimum and sign product (with the syndrome
// sign), scaled check-to-variable messages, variable totals summed in slot
// order, v2c = total - own c2v, hard decision, parity against the syndrome.
// Each shot freezes at its first convergence; a converged shot does no
// further work, which is exact because its outputs are frozen either way.
// Messages are float32.  The caller builds with -fmad=false so the
// arithmetic rounds like the plain PyTorch version (ops/bp_kernel.py).
//
// Layout: messages edge-major and shot-minor (v2c and c2v at
// [e * lanes + lane]), hard decisions at [j * lanes + lane], all in shared
// memory.  Thread t works for shot t % lanes on row t / lanes; the rows
// split the checks and the variables between barriers.  Every thread of the
// block must call decode(): it synchronises the block.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace minsum {

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
template <class Io>
__device__ void decode(const Graph& g, Io& io, float* v2c, float* c2v,
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
    for (int e = row; e < E; e += rows) v2c[e * lanes + lane] = io.llr0(g.chk_nbr[e]);
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
          const int e = i * rw + s;
          float mag = kBig;
          if (g.chk_mask[e]) {
            const float v = v2c[e * lanes + lane];
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
          const int e = i * rw + s;
          float c = 0.f;
          if (g.chk_mask[e]) {
            const float ex = fminf(s == amin ? min2 : min1, kBig);
            c = scale * ex;
            if ((sg < 0.f) != (((negs >> s) & 1u) != 0u)) c = -c;
          }
          c2v[e * lanes + lane] = c;
        }
      }
    }
    __syncthreads();

    // variable pass: totals summed in slot order, then v2c = total - own
    if (active) {
      for (int j = row; j < n; j += rows) {
        float acc = 0.f;
        for (int t = 0; t < cw; ++t) {
          const int q = j * cw + t;
          float c = 0.f;
          if (g.var_mask[q]) c = c2v[(g.var_nbr[q] * rw + g.var_slot[q]) * lanes + lane];
          acc = (t == 0) ? c : acc + c;
        }
        const float total = io.llr0(j) + acc;
        for (int t = 0; t < cw; ++t) {
          const int q = j * cw + t;
          if (g.var_mask[q]) {
            const int e = (g.var_nbr[q] * rw + g.var_slot[q]) * lanes + lane;
            v2c[e] = total - c2v[e];
          }
        }
        const uint8_t h = total < 0.f ? 1 : 0;
        hard[j * lanes + lane] = h;
        io.store_var(j, h, total);
      }
    }
    __syncthreads();

    // parity pass: the hard decision must reproduce every syndrome bit
    if (active) {
      for (int i = row; i < m; i += rows) {
        unsigned par = io.synd(i);
        for (int s = 0; s < rw; ++s) {
          const int e = i * rw + s;
          if (g.chk_mask[e]) par ^= hard[g.chk_nbr[e] * lanes + lane];
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
