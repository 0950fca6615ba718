// The int8 scaled min-sum decode of one tile of shots, run by a thread-block
// cluster: the body shared by the int8 BP head (bp_int8.cu, kernel B6) and
// the int8 mode of the whole-pipeline fused decode (fused_decode_int8.cu),
// so both run one copy of the arithmetic — the JAX package's
// _minsum_int8_loop (qldpc_fault_tolerance_tpu/ops/bp_pallas.py:571).
//
// Function (ops/bp_kernel.py minsum_int8_plain): v2c and c2v messages are
// int8, each direction with ONE float32 scale per tile per iteration,
// q = max(tile max |message| * f32(1/127), 1e-30), taken over every shot of
// the tile, converged or not, padded slots included as 0.  A message p is
// stored as rint(clamp(p / q, -127, 127)) with an IEEE division.  The check
// update runs on the raw int8 magnitudes (padded slots 2^30, ties to the
// first slot); c2v = ((scale * signs) * (excl * qv)); the variable totals are
// llr0 + qc * (integer sum of the int8 c2v), one fused multiply-add; the
// gather reads bf16(totals); v2c = t_e - qc * c2v_int8, one fused
// multiply-add.  Parity comes from t_e < 0, the hard decision from
// totals < 0.  Outputs freeze at each shot's first convergence; its messages
// go on, because they enter the tile's maxima.  With early_stop the tile
// leaves its loop when all its shots have converged.
//
// Layout: a tile is one cluster of blocks, `lanes` shots each.  Each block
// keeps its shots' int8 messages (one buffer: the check pass turns v2c into
// c2v in place and the gather pass c2v into the next v2c, each check's edges
// owned by one thread) and their bf16 totals in shared memory, at
// [index * lanes + lane].  The float32 messages are never stored: each pass
// that needs a tile maximum runs twice, once for the maximum and once to
// quantize.  A tile maximum is a block reduction (warp shuffles); after a
// cluster barrier every block reads the others' partial maxima through
// distributed shared memory.  The maxima are order-free, so every block gets
// the same scale.  The "all converged" flag of early_stop rides with the
// second maximum.  Two cluster barriers per iteration.  The caller builds
// with -fmad=false; the two fused multiply-adds are explicit (__fmaf_rn), as
// XLA's CPU backend contracts the JAX package's expressions.  Every thread of
// the cluster must call decode(); a block must not leave, or start another
// decode, before a cluster barrier that follows it (the others may still
// read its partial maxima).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8body {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 32;
constexpr int32_t kBigI32 = 1 << 30;
constexpr float kInv127 = 1.0f / 127.0f;  // float32(1/127), as XLA folds it

__device__ __forceinline__ float tile_scale(float tmax) {
  return fmaxf(tmax * kInv127, 1e-30f);
}

__device__ __forceinline__ int8_t quantize(float p, float q) {
  return (int8_t)__float2int_rn(fminf(fmaxf(p / q, -127.f), 127.f));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Static shared state of a block: the reductions' partials and the per-shot
// decode state.
struct Shared {
  float warp[kWarps];  // per-warp maxima
  float cta[2];        // this block's partial maxima, one slot per direction
  int cta_done[2];     // this block's "all converged"
  float out;           // the tile maximum
  int out_done;        // the tile's "all converged"
  int done[kMaxLanes];   // converged
  int bad[kMaxLanes];    // parity failed this iteration
  int iters[kMaxLanes];  // iteration of first convergence, head_iters if none
};

// The tile maximum of every thread's `v` (>= 0) and, with it, whether every
// block of the tile reports `done`; every thread of the cluster must call it.
// Slot k alternates between the two reductions of an iteration, so a block
// never overwrites a partial that another block may still read.
__device__ float tile_max(float v, int done, int k, Shared& sh,
                          cg::cluster_group& cluster, int* all_done) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) sh.warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mx = 0.f;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sh.warp[w]);
    sh.cta[k] = mx;
    sh.cta_done[k] = done;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    float mx = 0.f;
    int all = 1;
    for (unsigned b = 0; b < cluster.num_blocks(); ++b) {
      mx = fmaxf(mx, *cluster.map_shared_rank(&sh.cta[k], b));
      all &= *cluster.map_shared_rank(&sh.cta_done[k], b);
    }
    sh.out = mx;
    sh.out_done = all;
  }
  __syncthreads();
  if (all_done) *all_done = sh.out_done;
  return sh.out;
}

struct Check {
  int32_t min1, min2;
  int amin;
  unsigned negs;  // bit s: slot s's message is negative
  bool neg_tot;   // sign product with the syndrome sign
};

// Streaming top-2 of check i's int8 magnitudes and its sign product.
__device__ __forceinline__ Check check_update(const int8_t* msg,
                                              const float* mask, int i, int m,
                                              int rw, int lanes, int lane,
                                              uint8_t synd) {
  Check c{kBigI32, kBigI32, 0, 0u, synd != 0};
  for (int s = 0; s < rw; ++s) {
    const int e = s * m + i;
    int32_t mag = kBigI32;
    if (mask[e] > 0.f) {
      const int v = msg[e * lanes + lane];
      mag = v < 0 ? -v : v;
      if (v < 0) {
        c.negs |= 1u << s;
        c.neg_tot = !c.neg_tot;
      }
    }
    if (mag < c.min1) {
      c.min2 = c.min1;
      c.min1 = mag;
      c.amin = s;
    } else if (mag < c.min2) {
      c.min2 = mag;
    }
  }
  return c;
}

// Dequantized c2v of slot s: ((scale * signs) * (excl * qv)), 0 if padded.
__device__ __forceinline__ float c2v_value(const Check& c, int s, bool valid,
                                           float qv, float scale) {
  if (!valid) return 0.f;
  int32_t ex = s == c.amin ? c.min2 : c.min1;
  ex = ex < kBigI32 ? ex : kBigI32;
  const float mag = scale * ((float)ex * qv);
  return (c.neg_tot != (((c.negs >> s) & 1u) != 0u)) ? -mag : mag;
}

// A sector's slot-major index planes (ops/bp_kernel.py SparseHeadGraph), in
// device memory; edge s * m + i is check i's slot s.
struct Planes {
  const int32_t* chk_idx;   // (rw, m)
  const float* mask;        // (rw, m)
  const int32_t* var_edge;  // (n, cw), -1 pads
  const float* llr0;        // (n,)
  int m, n, rw, cw;
};

// Io supplies the shot's syndrome bit synd(i), is told of each variable's
// start (init_var(j)) and, every iteration, of each variable's total and
// whether the shot is still live (store_var(j, total, live); every thread
// calls it, live or not).
template <class Io>
__device__ void decode(const Planes& g, Io& io, int8_t* msg,
                       __nv_bfloat16* totb, Shared& sh,
                       cg::cluster_group& cluster, int lanes, int lane,
                       int row, int rows, int head_iters, float scale,
                       bool early_stop) {
  const int m = g.m, n = g.n, rw = g.rw, cw = g.cw;
  const int32_t* chk_idx = g.chk_idx;
  const float* mask = g.mask;
  const float* llr0 = g.llr0;
  if (row == 0) {
    sh.done[lane] = 0;
    sh.bad[lane] = 0;
    sh.iters[lane] = head_iters;
  }
  for (int j = row; j < n; j += rows) io.init_var(j);

  // init: bf16 channel LLRs gathered onto the edges, quantized at their own
  // tile maximum
  float local = 0.f;
  for (int i = row; i < m; i += rows)
    for (int s = 0; s < rw; ++s) {
      const int e = s * m + i;
      if (mask[e] > 0.f) local = fmaxf(local, fabsf(bf16_round(llr0[chk_idx[e]])));
    }
  float qv = tile_scale(tile_max(local, 0, 1, sh, cluster, nullptr));
  for (int i = row; i < m; i += rows)
    for (int s = 0; s < rw; ++s) {
      const int e = s * m + i;
      const float t = mask[e] > 0.f ? bf16_round(llr0[chk_idx[e]]) : 0.f;
      msg[e * lanes + lane] = quantize(t, qv);
    }
  __syncthreads();

  for (int it = 0; it < head_iters; ++it) {
    // check pass, twice: the c2v tile maximum, then c2v quantized in place
    local = 0.f;
    for (int i = row; i < m; i += rows) {
      const Check c = check_update(msg, mask, i, m, rw, lanes, lane, io.synd(i));
      for (int s = 0; s < rw; ++s)
        local = fmaxf(local, fabsf(c2v_value(c, s, mask[s * m + i] > 0.f, qv, scale)));
    }
    const float qc = tile_scale(tile_max(local, 0, 0, sh, cluster, nullptr));
    for (int i = row; i < m; i += rows) {
      const Check c = check_update(msg, mask, i, m, rw, lanes, lane, io.synd(i));
      for (int s = 0; s < rw; ++s) {
        const int e = s * m + i;
        msg[e * lanes + lane] = quantize(c2v_value(c, s, mask[e] > 0.f, qv, scale), qc);
      }
    }
    __syncthreads();

    // variable pass: exact integer sum of the int8 c2v, then the totals
    const bool live = !sh.done[lane];
    for (int j = row; j < n; j += rows) {
      int acc = 0;
      for (int t = 0; t < cw; ++t) {
        const int e = g.var_edge[j * cw + t];
        if (e >= 0) acc += msg[e * lanes + lane];
      }
      const float total = __fmaf_rn(qc, (float)acc, llr0[j]);
      totb[j * lanes + lane] = __float2bfloat16_rn(total);
      io.store_var(j, total, live);
    }
    __syncthreads();

    // gather pass: parity and the v2c tile maximum
    local = 0.f;
    for (int i = row; i < m; i += rows) {
      unsigned par = io.synd(i);
      for (int s = 0; s < rw; ++s) {
        const int e = s * m + i;
        if (mask[e] > 0.f) {
          const float te = __bfloat162float(totb[chk_idx[e] * lanes + lane]);
          const float v = __fmaf_rn(-qc, (float)msg[e * lanes + lane], te);
          local = fmaxf(local, fabsf(v));
          if (te < 0.f) par ^= 1u;
        }
      }
      if (par & 1u) sh.bad[lane] = 1;
    }
    __syncthreads();
    if (row == 0) {
      if (!sh.bad[lane] && !sh.done[lane]) {
        sh.done[lane] = 1;
        sh.iters[lane] = it + 1;
      }
      sh.bad[lane] = 0;
    }
    __syncthreads();
    int cta_done = 1;
    for (int l = 0; l < lanes; ++l) cta_done &= sh.done[l];
    int all_done = 0;
    qv = tile_scale(tile_max(local, cta_done, 1, sh, cluster, &all_done));

    // v2c quantized in place of the c2v it subtracts
    for (int i = row; i < m; i += rows)
      for (int s = 0; s < rw; ++s) {
        const int e = s * m + i;
        float v = 0.f;
        if (mask[e] > 0.f) {
          const float te = __bfloat162float(totb[chk_idx[e] * lanes + lane]);
          v = __fmaf_rn(-qc, (float)msg[e * lanes + lane], te);
        }
        msg[e * lanes + lane] = quantize(v, qv);
      }
    __syncthreads();
    if (early_stop && all_done) break;
  }
}

}  // namespace int8body
