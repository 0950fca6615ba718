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
// Design.  A tile is one cluster of blocks of 1024 threads, `lanes` shots
// each (32 at hgp_34_n625: a warp is one row of 32 shots, so index loads are
// warp-uniform broadcasts and message loads 32 consecutive bytes).  An
// iteration is four block-wide passes and two tile maxima:
//   check pass   v2c = quantize(t_e - qc * c2v, qv) of each edge (at the
//                first iteration the quantized bf16 channel LLRs), written
//                over the c2v it came from and added into the check's top-2
//                and sign product; the c2v maximum needs no c2v: over a
//                check's slots |c2v| peaks at the amin slot,
//                |scale * (min2 * qv)|, since rounding is monotone;
//   c2v pass     (after the c2v tile maximum) the check's top-2 again from
//                its int8 v2c (integer work), two quantizations per check,
//                of the min1 and min2 magnitudes, signed per slot (quantize
//                is odd), into the message buffer;
//   variable pass exact integer sums of the int8 c2v -> totals, bf16 totals;
//   gather pass  parity and the v2c maximum; the shots' convergence is
//                settled inside the tile maximum that follows.
// So every v2c and every division by a scale happens once per iteration;
// v2c is recomputed once (an fma over shared memory) because it must wait
// for its tile maximum.  Shared memory holds, at [index * lanes + lane],
// the int8 messages (one buffer: v2c between the check and the c2v pass,
// c2v otherwise) and the bf16 totals; the caller adds a 16-bit copy of
// the index plane with padding folded into -1 (once per block, kStaged)
// where it fits beside them, and otherwise the passes read chk_idx and
// mask from device memory.  A tile maximum is a warp-shuffle reduction
// per warp, one more in warp 0 over the warps, a cluster barrier, then
// warp 0 reads the other blocks' partial maxima through distributed shared
// memory at once and reduces them.  The maxima
// are order-free, so every block gets the same scale.  The "all converged"
// flag of early_stop rides with the v2c maximum.  Two cluster barriers per
// iteration.  The caller builds with -fmad=false; the two fused
// multiply-adds are explicit (__fmaf_rn), as XLA's CPU backend contracts the
// JAX package's expressions.  Every thread of the cluster must call
// decode(); a block must not leave, or start another decode, before a
// cluster barrier that follows it (the others may still read its partial
// maxima).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace int8body {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 32;
constexpr int32_t kBigI32 = 1 << 30;
constexpr float kInv127 = 1.0f / 127.0f;  // float32(1/127), as XLA folds it

static_assert(kWarps == 32, "warp 0 reduces one partial per warp");

__device__ __forceinline__ float tile_scale(float tmax) {
  return fmaxf(tmax * kInv127, 1e-30f);
}

__device__ __forceinline__ int quantize(float p, float q) {
  return __float2int_rn(fminf(fmaxf(p / q, -127.f), 127.f));
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
// block of the tile reports all its shots converged; every thread of the
// cluster must call it.  With `settle`, the block's shots first settle this
// iteration's parity: a shot whose checks all held converges at `it + 1`.
// Slot k alternates between the two reductions of an iteration, so a block
// never overwrites a partial that another block may still read.
__device__ float tile_max(float v, int k, Shared& sh,
                          cg::cluster_group& cluster, int lanes, bool settle,
                          int it, int* all_done) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane32 = threadIdx.x & 31;
  if (lane32 == 0) sh.warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    int done = 1;
    if (lane32 < lanes) {
      if (settle) {
        if (!sh.bad[lane32] && !sh.done[lane32]) {
          sh.done[lane32] = 1;
          sh.iters[lane32] = it + 1;
        }
        sh.bad[lane32] = 0;
      }
      done = sh.done[lane32];
    }
    const int cta_done = __all_sync(0xffffffffu, done);
    float mx = sh.warp[lane32];
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane32 == 0) {
      sh.cta[k] = mx;
      sh.cta_done[k] = cta_done;
    }
  }
  cluster.sync();
  if (threadIdx.x < 32) {
    float mx = 0.f;
    int all = 1;
    if (lane32 < (int)cluster.num_blocks()) {
      mx = *cluster.map_shared_rank(&sh.cta[k], lane32);
      all = *cluster.map_shared_rank(&sh.cta_done[k], lane32);
    }
    all = __all_sync(0xffffffffu, all);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane32 == 0) {
      sh.out = mx;
      sh.out_done = all;
    }
  }
  __syncthreads();
  if (all_done) *all_done = sh.out_done;
  return sh.out;
}

// A check's update over the int8 v2c of its real slots: the top-2
// magnitudes (ties to the first slot; padding, magnitude 2^30, never
// changes them) and the sign product.  A slot is a bit of a Mask:
// `uint32_t` for row weights up to 32 (the code every rw <= 32 instance
// compiles to), `uint64_t` up to 64 (kMaxRowWeight; the wide instances).
template <class Mask = uint32_t>
struct CheckUpdate {
  int32_t min1 = kBigI32, min2 = kBigI32;
  int amin = 0;
  Mask negs = 0u;  // the slots whose v2c is negative
  bool neg_tot;    // syndrome bit xor every slot's sign
  __device__ explicit CheckUpdate(bool synd) : neg_tot(synd) {}
  __device__ __forceinline__ void add(int s, int q) {
    const int32_t mag = q < 0 ? -q : q;
    if (q < 0) {
      negs |= Mask(1) << s;
      neg_tot = !neg_tot;
    }
    if (mag < min1) {
      min2 = min1;
      min1 = mag;
      amin = s;
    } else if (mag < min2) {
      min2 = mag;
    }
  }
  // the slots whose c2v is negative: the product less the slot's own sign
  __device__ __forceinline__ Mask c2v_negs() const {
    return neg_tot ? ~negs : negs;
  }
};

constexpr int kMaxRowWeight = 64;

// |c2v| of a slot whose excluded minimum is `mag`: scale * (excl * qv)
__device__ __forceinline__ float c2v_mag(int32_t mag, float qv, float scale) {
  return scale * ((float)mag * qv);
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

// A block's shared-memory buffers, [index * lanes + lane] unless noted.
struct Work {
  int8_t* msg;          // rw * m int8 messages
  __nv_bfloat16* totb;  // n bf16 totals
  int16_t* idx;         // rw * m: chk_idx, -1 for padding (not per shot);
                        // only with kStaged (n < 2^15)
};

// Io supplies the shot's syndrome bit synd(i), is told of each variable's
// start (init_var(j)) and, every iteration, of each variable's total and
// whether the shot is still live (store_var(j, total, live); every thread
// calls it, live or not).  kStaged: the index plane is copied into w.idx
// (the caller's choice, from the shape: when it fits); else every pass reads
// chk_idx and mask from device memory.  kWide: row weights 33..64, 64-bit
// slot masks (CheckUpdate); otherwise up to 32.
template <bool kStaged, bool kWide, class Io>
__device__ void decode(const Planes& g, Io& io, const Work& w, Shared& sh,
                       cg::cluster_group& cluster, int lanes, int lane,
                       int row, int rows, int head_iters, float scale,
                       bool early_stop) {
  using Mask = typename std::conditional<kWide, uint64_t, uint32_t>::type;
  const int m = g.m, n = g.n, rw = g.rw, cw = g.cw;
  const float* llr0 = g.llr0;
  int8_t* msg = w.msg;
  const __nv_bfloat16* totb = w.totb;
  // the variable of edge e, -1 for padding
  auto var_of = [&](int e) -> int {
    if constexpr (kStaged) return w.idx[e];
    else return g.mask[e] > 0.f ? g.chk_idx[e] : -1;
  };
  if constexpr (kStaged)
    for (int e = threadIdx.x; e < rw * m; e += kThreads)
      w.idx[e] = (int16_t)(g.mask[e] > 0.f ? g.chk_idx[e] : -1);
  if (row == 0) {
    sh.done[lane] = 0;
    sh.bad[lane] = 0;
    sh.iters[lane] = head_iters;
  }
  for (int j = row; j < n; j += rows) io.init_var(j);
  __syncthreads();

  // the first v2c: bf16 channel LLRs gathered onto the edges, quantized at
  // their own tile maximum
  float local = 0.f;
  for (int i = row; i < m; i += rows)
    for (int s = 0; s < rw; ++s) {
      const int v = var_of(s * m + i);
      if (v >= 0) local = fmaxf(local, fabsf(bf16_round(llr0[v])));
    }
  float qv = tile_scale(tile_max(local, 1, sh, cluster, lanes, false, 0, nullptr));
  float qc = 0.f;

  for (int it = 0; it < head_iters; ++it) {
    // check pass: each v2c quantized into its edge's message (in place of
    // the c2v it was made from) and into its check's top-2
    local = 0.f;
    for (int i = row; i < m; i += rows) {
      CheckUpdate<Mask> cu(io.synd(i) != 0);
      for (int s = 0; s < rw; ++s) {
        const int e = s * m + i;
        const int v = var_of(e);
        if (v >= 0) {
          const float x =
              it == 0 ? bf16_round(llr0[v])
                      : __fmaf_rn(-qc, (float)msg[e * lanes + lane],
                                  __bfloat162float(totb[v * lanes + lane]));
          const int q = quantize(x, qv);
          msg[e * lanes + lane] = (int8_t)q;
          cu.add(s, q);
        }
      }
      if (cu.min1 < kBigI32)
        local = fmaxf(local, fabsf(c2v_mag(cu.min2, qv, scale)));
    }
    qc = tile_scale(tile_max(local, 0, sh, cluster, lanes, false, it, nullptr));

    // c2v pass: the check's top-2 again from its int8 v2c (integer work),
    // then the min1 and min2 messages quantized once per check
    for (int i = row; i < m; i += rows) {
      CheckUpdate<Mask> cu(io.synd(i) != 0);
      Mask real = 0u;  // the check's real slots
      for (int s = 0; s < rw; ++s) {
        const int e = s * m + i;
        if (var_of(e) >= 0) {
          real |= Mask(1) << s;
          cu.add(s, msg[e * lanes + lane]);
        }
      }
      const int q1 = quantize(c2v_mag(cu.min1, qv, scale), qc);
      const int q2 = quantize(c2v_mag(cu.min2, qv, scale), qc);
      const Mask neg = cu.c2v_negs();
      for (int s = 0; s < rw; ++s) {
        const int e = s * m + i;
        if ((real >> s) & Mask(1)) {
          const int q = s == cu.amin ? q2 : q1;
          msg[e * lanes + lane] = (int8_t)((neg >> s) & Mask(1) ? -q : q);
        }
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
      w.totb[j * lanes + lane] = __float2bfloat16_rn(total);
      io.store_var(j, total, live);
    }
    __syncthreads();

    // gather pass: parity and the v2c tile maximum
    local = 0.f;
    for (int i = row; i < m; i += rows) {
      unsigned par = io.synd(i);
      for (int s = 0; s < rw; ++s) {
        const int e = s * m + i;
        const int v = var_of(e);
        if (v >= 0) {
          const float te = __bfloat162float(totb[v * lanes + lane]);
          local = fmaxf(local,
                        fabsf(__fmaf_rn(-qc, (float)msg[e * lanes + lane], te)));
          if (te < 0.f) par ^= 1u;
        }
      }
      if (par & 1u) sh.bad[lane] = 1;
    }
    int all_done = 0;
    qv = tile_scale(tile_max(local, 1, sh, cluster, lanes, true, it, &all_done));
    if (early_stop && all_done) break;
  }
}

}  // namespace int8body
