// The scaled min-sum arithmetic of one check and of one variable, and the
// loop that decodes one shot on a lane of warps, shared by the min-sum
// kernels (bp_minsum.cu: kernel 1 and the bf16 head) and the
// whole-pipeline fused decode's bf16 mode (fused_decode.cu), so all run one
// copy of it.
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
//           ops/bp_kernel.py minsum_planes); v2c = bf16(bf16(total) - c2v)
//           and parity reads bf16(total).
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

constexpr float kBig = 1e30f;  // stands in for +inf, as ops/bp.py _BIG
constexpr int kMaxLanes = 15;  // named barriers 1..15, barrier 0 is the block's
constexpr int kPad = 0xFFFF;   // a padded entry of the 16-bit planes

// The named barrier of lane `lane`, `count` threads (whole warps), in the
// non-aligned form: `barrier.sync`, where `bar.sync` would be
// `barrier.sync.aligned`, which tells ptxas that every thread of the block
// executes that same barrier instruction, an assumption it may optimise on.
// The lanes of a block reach their barriers at different points and a
// lane's threads diverge between barriers, so only the non-aligned form
// matches what the loop does.  Built with the aligned form at -O3, the
// device-memory mode with 32-bit planes (csrc/bp_minsum.cu kMem 2) gave
// wrong outputs or illegal addresses at some shapes (e.g. 120 x 600 random
// matrices); every instance now takes the non-aligned form.
__device__ __forceinline__ void lane_sync(int lane, int count) {
  asm volatile("barrier.sync %0, %1;" ::"r"(lane + 1), "r"(count) : "memory");
}

// lane_sync that returns whether any thread of the lane gave `pred`
__device__ __forceinline__ bool lane_sync_or(int lane, int count, bool pred) {
  int any;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 p, %1, 0;\n\t"
      "barrier.red.or.pred q, %2, %3, p;\n\t"
      "selp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(any)
      : "r"((int)pred), "r"(lane + 1), "r"(count)
      : "memory");
  return any != 0;
}

// A check's state after its v2c: the two smallest magnitudes (kBig for
// padding), the slot of the first, each live slot's negative sign as a bit
// of a Mask, and whether the product of the signs and the syndrome sign is
// negative.  Mask is `unsigned` for row weights up to 32 (the code every
// rw <= 32 instance compiles to) and `unsigned long long` for up to 64
// (kMaxRowWeight), the detector error models' wide rows.
template <class Mask = unsigned>
struct Top2 {
  float min1, min2;
  int amin;
  Mask negs;
  bool neg;
};

constexpr int kMaxRowWeight = 64;

// the row weights one Mask numbers
template <class Mask>
constexpr int mask_slots() {
  return 8 * (int)sizeof(Mask);
}

// The streaming top-2 over a check's rw slots in slot order; v(s, x) gives
// slot s's v2c in x and returns false for a padded slot.
template <class Mask = unsigned, class V>
__device__ __forceinline__ Top2<Mask> check_top2(int rw, bool synd, V v) {
  float sg = synd ? -1.f : 1.f;
  float min1 = kBig, min2 = kBig;
  int amin = 0;
  Mask negs = 0u;
  for (int s = 0; s < rw; ++s) {
    float x, mag = kBig;
    if (v(s, x)) {
      mag = fabsf(x);
      if (x < 0.f) {
        negs |= Mask(1) << s;
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
  return Top2<Mask>{min1, min2, amin, negs, sg < 0.f};
}

// the scaled c2v of live slot s
template <class Mask>
__device__ __forceinline__ float check_c2v(const Top2<Mask>& c, int s,
                                           float scale) {
  float r = scale * fminf(s == c.amin ? c.min2 : c.min1, kBig);
  if (c.neg != (((c.negs >> s) & Mask(1)) != 0u)) r = -r;
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

// The graph as the kernels read it (ops/bp_kernel.py minsum_planes): edge
// s * m + i is check i's slot-s edge.  16-bit planes (Planes) are staged in
// shared memory; 32-bit ones (Planes32, for graphs that 16 bits cannot
// number or whose planes do not fit a block) are read from device memory.
template <class Idx>
struct PlanesT {
  // a padded entry as the int it loads as
  using Index = Idx;
  static constexpr int kPad = sizeof(Idx) == 2 ? minsum::kPad : -1;
  const Idx* chk;       // (rw, m): the variable of each edge, kPad if none
  const Idx* edge;      // (cw, n): variable j's t-th edge in summation order
  const uint8_t* slot;  // (cw, n): that edge's slot (Bf16Msg only)
  int m, n, rw, cw;
};
using Planes = PlanesT<uint16_t>;
using Planes32 = PlanesT<uint32_t>;

// One shot's decode, max_iter >= 1 iterations at most and row weights up to
// mask_slots<Mask>() (Top2), on a lane of `tpl` threads (whole warps) with
// its own named barrier (lane_sync); thread r of the lane owns checks
// i = r (mod tpl) and variables j = r (mod tpl).  synd(i) gives check i's syndrome bit (called once, by check i's thread, and kept in
// syn) and llr0(j) variable j's channel LLR.  Per lane shared memory holds
// c2v at [s * m + i] (4 bytes per edge), v2c at the same index, the totals
// (4 * n) and the syndrome (m); in shared memory, or in device memory for
// the min-sum kernels' device-memory modes (a lane barrier orders either).
// One iteration is two lane barriers:
//   variable pass  totals (kept in shared memory), new v2c;   lane_sync
//   check pass     parity of those totals and, unless it was the last
//                  iteration, the next check update;          lane_sync_or
// The or-barrier tells every thread whether a check failed; the check
// update that follows a converged iteration is discarded.  The first check
// update reads the channel LLRs.  Returns whether the last iteration's
// parity failed, with its number in `it`; tot then holds that iteration's
// totals, which each thread may read back for its own variables without a
// barrier.  c2v, v2c and syn are free on return (the last barrier followed
// every read of them); tot once the lane has passed its next barrier.
//
// A sector (bp_minsum.cu's sector mode): checks [c0, c1) and variables
// [v0, v1) of a block-diagonal graph whose messages never leave the block;
// the lane then walks only those, by their indices in the whole graph, so
// each check, each variable and each sum is the one a decode of that block
// alone computes.  By default (c1, v1 < 0) the whole graph.
template <class Msg, class Mask = unsigned, class Synd, class Llr, class G>
__device__ __forceinline__ bool lane_decode(const G& g, Synd synd,
                                            Llr llr0, float* c2v,
                                            typename Msg::T* v2c, float* tot,
                                            uint8_t* syn, int max_iter,
                                            float scale, int lane, int r,
                                            int tpl, int& it, int c0 = 0,
                                            int c1 = -1, int v0 = 0,
                                            int v1 = -1) {
  const int m = g.m, n = g.n, rw = g.rw, cw = g.cw;
  const int ce = c1 < 0 ? m : c1, ve = v1 < 0 ? n : v1;
  // check i's scaled c2v on its live slots (bit s of `live`)
  auto put_c2v = [&](int i, const Top2<Mask>& c, Mask live) {
    for (int s = 0; s < rw; ++s)
      if ((live >> s) & Mask(1)) c2v[s * m + i] = check_c2v(c, s, scale);
  };

  // iteration 1's check update, from the channel LLRs
  for (int i = c0 + r; i < ce; i += tpl) {
    const uint8_t sb = synd(i);
    syn[i] = sb;
    Mask live = 0u;
    const Top2<Mask> c = check_top2<Mask>(rw, sb, [&](int s, float& x) {
      const int v = g.chk[s * m + i];
      if (v == G::kPad) return false;
      live |= Mask(1) << s;
      x = Msg::load(Msg::store(llr0(v)));
      return true;
    });
    put_c2v(i, c, live);
  }
  it = 0;
  bool bad;
  for (;;) {
    lane_sync(lane, tpl);
    for (int j = v0 + r; j < ve; j += tpl) {
      const float total = var_total<Msg>(llr0(j), cw, [&](int t, float& c, int& s) {
        const int e = g.edge[t * n + j];
        if (e == G::kPad) return false;
        s = Msg::kBf16 ? g.slot[t * n + j] : 0;
        c = c2v[e];
        return true;
      });
      const float t_e = gather_total<Msg>(total);
      for (int t = 0; t < cw; ++t) {
        const int e = g.edge[t * n + j];
        if (e != G::kPad) v2c[e] = Msg::store(t_e - c2v[e]);
      }
      tot[j] = total;
    }
    ++it;
    lane_sync(lane, tpl);
    // each check's parity of these totals and, unless this was the last
    // iteration, its next check update, in one walk over its slots
    bool fail = false;
    for (int i = c0 + r; i < ce; i += tpl) {
      const bool sb = syn[i];
      unsigned par = sb;
      Mask live = 0u;
      if (it < max_iter) {
        const Top2<Mask> c = check_top2<Mask>(rw, sb, [&](int s, float& x) {
          const int e = s * m + i, v = g.chk[e];
          if (v == G::kPad) return false;
          live |= Mask(1) << s;
          par ^= gather_total<Msg>(tot[v]) < 0.f;
          x = Msg::load(v2c[e]);
          return true;
        });
        put_c2v(i, c, live);
      } else {
        for (int s = 0; s < rw; ++s) {
          const int v = g.chk[s * m + i];
          if (v != G::kPad) par ^= gather_total<Msg>(tot[v]) < 0.f;
        }
      }
      fail |= (par & 1u) != 0u;
    }
    bad = lane_sync_or(lane, tpl, fail);
    if (!bad || it == max_iter) return bad;
  }
}

}  // namespace minsum
