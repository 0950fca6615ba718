// Scaled min-sum belief propagation for a batch of syndromes: kernel 1
// (float32 messages) and the bf16 BP head, two instances of one loop.
//
// Replaces the TPU kernel _sparse_head_kernel
// (qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740, loop body
// _minsum_plane_loop at :227) in its bf16 mode, and the dense v1 head
// _head_kernel (:335), which runs the same loop over a resident one-hot
// stack; both use one-hot MXU products standing in for gathers.  Here the
// gathers are plain loads through index planes in shared memory.
//
// Function: per-check top-2 minimum and sign product (with the syndrome
// sign), scaled check-to-variable messages, variable totals, v2c = total -
// own c2v, hard decision, parity against the syndrome (minsum_body.cuh,
// whose per-shot loop B5's bf16 mode runs too).  Each shot's outputs (error,
// posterior, iterations) are those of its first converged iteration, or of
// iteration max_iter.
//   bp_minsum_launch (kernel 1; ops/bp.py bp_decode(method="minimum_sum"),
//     plain version minsum_plain): float32 messages, variable totals summed
//     in the order of the Tanner graph's lists.
//   bp_minsum_bf16_launch (the bf16 head; ops/bp_kernel.py bp_head_bf16,
//     plain version minsum_dense_plain): bf16 v2c, each variable's terms
//     summed slot by slot in ascending check order.  Its shots are
//     independent, so the JAX tile (which only gates whether the head runs)
//     plays no part, and leaving at convergence is the tile early exit's
//     result.
//
// Design.  A block holds `lanes` shots at a time; each lane is `tpl`
// threads (whole warps) that decode one shot with their own named barrier
// (barrier.sync lane + 1), so no lane waits for another.  When a lane's shot
// converges or reaches max_iter, the lane writes that shot's outputs,
// claims the next shot from a device counter (atomicAdd; the wrapper zeroes
// it) and starts it; the block leaves when the counter passes the batch.
// The wrapper launches as many blocks as the batch needs, at most what the
// card holds at once (ops/bp_kernel.py minsum_layout): a large batch keeps
// every SM full of shots, a small one (the two-phase tail) gives each shot
// up to a whole block, one check and one variable per thread.  A shot's
// outputs depend only on its syndrome, so the order of the claims changes
// no bit.  A lane decodes its shot with minsum_body.cuh lane_decode: thread
// r owns checks i = r (mod tpl) and variables j = r (mod tpl), and one
// iteration is two lane barriers (a variable pass, then a check pass that
// takes the parity and the next check update, on an or-barrier).
//
// Shared memory: the block's graph, staged once from the host-built planes
// (ops/bp_kernel.py minsum_planes): each check slot's variable (2 * rw * m
// bytes, 0xFFFF for padding), each variable's edges s * m + i in summation
// order (2 * cw * n) and, for the bf16 head, their slots (cw * n: no term
// needs a quotient), and the channel LLRs when the shots share them (4 * n);
// then per lane c2v (4 per edge), v2c (4 or 2 per edge), the totals (4 * n)
// and the syndrome (m); each piece rounded up to 16 bytes.  At hgp_34_n625
// (m = 300, n = 625, rw = 7, cw = 4): 11,728 B staged and 19,616 B per
// shot (float32), 14,240 B and 15,424 B (bf16).  Device memory sees each
// shot's syndrome and LLRs read once and its outputs written once.
//
// Device-memory modes (kMem, a template flag; ops/bp_kernel.py
// minsum_layout picks them where one shot's messages do not fit beside the
// staged planes in the 232,448 bytes a block may take):
//   kMem 1: each lane's c2v, v2c, totals and syndrome live in a device
//     scratch (grid x lanes regions of the per-lane bytes above, region
//     blockIdx.x * lanes + lane); the 16-bit planes and shared channel
//     LLRs stay staged in shared memory;
//   kMem 2: the planes do not fit a block, or 16 bits cannot number the
//     graph's edges and variables (65,535 or more): 32-bit planes and the
//     channel LLRs are read from device memory, no shared memory is
//     staged, and the lanes live in the scratch as in kMem 1.
// The loop, its order and its arithmetic are those of kMem 0, so the
// outputs are bit for bit the same; a lane barrier (every mode in the
// non-aligned form, minsum_body.cuh lane_sync) orders the lane's
// device-memory writes as it orders its shared ones.  kMem 0 (the shared-
// memory mode every shipped code takes) is unchanged; the scratch is the
// kernel's last argument, so the others keep their offsets.
//
// The check-state mode (kMem 3, bp_minsum_checks_kernel; minsum_layout
// takes it before kMem 1 and 2, wherever one shot's records fit): in kMem
// 1 and 2 every access of a shot's messages is a scattered 4-byte access to
// a device scratch (at phase 36's h1, 464,112 B a shot; 61 MB for the 132
// shots the card holds, past the 50 MB L2), and each block waits on them
// (PERF.md, section 6).  Here a shot's state is one 16-byte record per check
// (CheckRecords: its Top2, from which check_c2v rebuilds every c2v of the
// check) and the totals, in shared memory (53,712 B at h1); the check pass
// rebuilds each v2c as Msg::store(gather_total(tot[v]) - c2v) from the
// record it is about to overwrite, so no per-edge message is kept.  The
// loop calls minsum_body.cuh's check_top2, check_c2v, var_total and
// gather_total in the same slot and list order, with the same two lane
// barriers an iteration, claims and convergence rule, so the outputs are
// those of kMem 0 bit for bit; each walk stops at its list's last live
// entry (MinsumPlanes.lens).  The planes (kPlanes, a template flag) are
// staged 16-bit where they fit beside the lanes, else 16-bit read through
// L2, which every block shares, else 32-bit; the variable pass loads a
// variable's first kTerms entries at once.
//
// Sector mode (bp_minsum_sectors_launch; ops/bp.py bp_decode(sectors=), the
// JAX package's XLA sector decode, plain version minsum_plain with
// sectors): the graph is a block diagonal of n_sec sectors whose messages
// never leave their block (a FusedBPPair's hz (+) hx).  The claim counter
// hands out (shot, sector) items b * n_sec + s, and a lane decodes one
// sector of one shot: lane_decode walks only the sector's checks and
// variables, by their indices in the whole graph, so every sum is the one
// a decode of the sector alone adds (build_tanner_graph_host keeps each
// variable's list in its own sector's order) and a sector's outputs
// freeze at its own first converged iteration; conv and iters are per
// item, (B, n_sec), and the wrapper takes their AND and max.  A straggler
// in one sector no longer holds the other's lane.  The lane regions are
// those of the whole graph (the shared-memory and device-memory modes
// only; the check-state kernel decodes whole graphs).
//
// Row weights: a check's live slots and negative signs are bit masks
// (minsum_body.cuh Top2), 32-bit up to row weight 32; the wide instances
// (kWide, a template flag whose false value is the 32-bit code) take 64-bit
// masks and row weights up to 64, the detector error models' window
// matrices (row weight 59 at hgp_34_n625).  launch() picks the instance
// from rw; the loop, its order and its arithmetic are the same.
//
// Registers: __launch_bounds__(1024, 1) keeps ptxas from squeezing a
// 1024-thread block into 32 registers with spills (54-56 registers, one
// block per SM; the layout rule counts on that).
//
// Bound: the iterations are latency-bound chains of shared-memory passes
// between barriers; per shot-iteration the messages cost 16 B (f32) or
// 12 B (bf16) per edge of shared-memory traffic plus the gathers of the
// totals.  The check-state mode computes each c2v twice an iteration (once
// per pass) in place of storing it: it issues more instructions per edge
// and moves no message through device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "minsum_body.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLanes = minsum::kMaxLanes;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// byte offsets in dynamic shared memory (mirrored by ops/bp_kernel.py
// minsum_smem_bytes)
struct Offsets {
  size_t edge, slot, llr, lanes;  // staged planes (chk at 0), lane regions
  size_t v2c, tot, syn, lane;     // within a lane region (c2v at 0); its size
  __host__ __device__ Offsets(int m, int n, int rw, int cw, int msg_bytes,
                              bool slots, bool llr_shared) {
    const size_t E = (size_t)m * rw, V = (size_t)n * cw;
    edge = align16(2 * E);
    slot = edge + align16(2 * V);
    llr = slot + (slots ? align16(V) : 0);
    lanes = llr + (llr_shared ? align16(4 * (size_t)n) : 0);
    v2c = align16(4 * E);
    tot = v2c + align16(msg_bytes * E);
    syn = tot + align16(4 * (size_t)n);
    lane = syn + align16((size_t)m);
  }
};

template <class Msg, int kMem, bool kWide>
__global__ void __launch_bounds__(kMaxThreads, 1)
bp_minsum_kernel(const uint8_t* __restrict__ synd,     // (B, m)
                 const float* __restrict__ llr,        // (n,) or (B, n)
                 int llr_per_shot,
                 const uint16_t* __restrict__ chk_g,   // (rw, m)
                 const uint16_t* __restrict__ edge_g,  // (cw, n)
                 const uint8_t* __restrict__ slot_g,   // (cw, n), bf16 only
                 uint8_t* __restrict__ err,            // (B, n)
                 float* __restrict__ post,             // (B, n)
                 uint8_t* __restrict__ conv,           // (B,)
                 int32_t* __restrict__ iters,          // (B,)
                 int* __restrict__ next,               // claims, 0 at launch
                 int m, int n, int rw, int cw, int B, int max_iter,
                 float scale, int tpl,
                 unsigned char* lanes_g,  // lane regions; kMem > 0
                 int n_sec,               // sectors (1: the whole graph)
                 const int* __restrict__ sec_off) {  // (2 * (n_sec + 1),)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_shot[kMaxLanes][2];
  const Offsets o(m, n, rw, cw, sizeof(typename Msg::T), Msg::kBf16,
                  !llr_per_shot);
  uint16_t* chk = (uint16_t*)smem;
  uint16_t* edge = (uint16_t*)(smem + o.edge);
  uint8_t* slot = smem + o.slot;
  float* llr_s = (float*)(smem + o.llr);
  if (kMem < 2) {
    const int E = m * rw, V = n * cw;
    for (int k = threadIdx.x; k < E; k += blockDim.x) chk[k] = chk_g[k];
    for (int k = threadIdx.x; k < V; k += blockDim.x) {
      edge[k] = edge_g[k];
      if (Msg::kBf16) slot[k] = slot_g[k];
    }
    if (!llr_per_shot)
      for (int j = threadIdx.x; j < n; j += blockDim.x) llr_s[j] = llr[j];
    __syncthreads();
  }

  const int lane = threadIdx.x / tpl, r = threadIdx.x % tpl;
  unsigned char* mine =
      kMem == 0 ? smem + o.lanes + lane * o.lane
                : lanes_g + ((size_t)blockIdx.x * (blockDim.x / tpl) + lane) *
                                o.lane;
  float* c2v = (float*)mine;
  auto* v2c = (typename Msg::T*)(mine + o.v2c);
  float* tot = (float*)(mine + o.tot);
  uint8_t* syn = mine + o.syn;

  // the channel LLR of variable v for shot b
  auto llr0 = [&](int b, int v) {
    return llr_per_shot ? __ldg(llr + (size_t)b * n + v)
           : kMem == 2  ? __ldg(llr + v)
                        : llr_s[v];
  };
  using G = typename std::conditional<kMem == 2, minsum::Planes32,
                                      minsum::Planes>::type;
  using Idx = typename G::Index;
  const G g{kMem == 2 ? (const Idx*)chk_g : (const Idx*)chk,
            kMem == 2 ? (const Idx*)edge_g : (const Idx*)edge,
            kMem == 2 ? slot_g : slot, m, n, rw, cw};

  for (int k = 0;; ++k) {
    // the slot alternates, so a claim never overwrites one a thread of the
    // lane may still read
    if (r == 0) s_shot[lane][k & 1] = atomicAdd(next, 1);
    minsum::lane_sync(lane, tpl);
    // a work item: shot b's sector sec (the whole graph when n_sec == 1),
    // its checks [c0, c1) and variables [v0, v1)
    const int item = s_shot[lane][k & 1];
    if (item >= B * n_sec) return;
    const int b = item / n_sec, sec = item - b * n_sec;
    int c0 = 0, c1 = m, v0 = 0, v1 = n;
    if (n_sec > 1) {
      c0 = __ldg(sec_off + sec);
      c1 = __ldg(sec_off + sec + 1);
      v0 = __ldg(sec_off + n_sec + 1 + sec);
      v1 = __ldg(sec_off + n_sec + 2 + sec);
    }
    uint8_t* err_b = err + (size_t)b * n;
    float* post_b = post + (size_t)b * n;
    if (max_iter == 0) {
      for (int j = v0 + r; j < v1; j += tpl) {
        err_b[j] = 0;
        post_b[j] = llr0(b, j);
      }
      if (r == 0) {
        conv[item] = 0;
        iters[item] = 0;
      }
      continue;
    }
    const uint8_t* synd_b = synd + (size_t)b * m;
    int it;
    using Mask =
        typename std::conditional<kWide, unsigned long long, unsigned>::type;
    const bool bad = minsum::lane_decode<Msg, Mask>(
        g, [&](int i) { return synd_b[i]; }, [&](int v) { return llr0(b, v); },
        c2v, v2c, tot, syn, max_iter, scale, lane, r, tpl, it, c0, c1, v0,
        v1);
    // the totals of the last iteration, each read by the thread that wrote it
    for (int j = v0 + r; j < v1; j += tpl) {
      const float t = tot[j];
      err_b[j] = t < 0.f ? 1 : 0;
      post_b[j] = t;
    }
    if (r == 0) {
      conv[item] = bad ? 0 : 1;
      iters[item] = bad ? max_iter : it;
    }
  }
}

// The check-state mode (kMem 3): per lane one 16-byte record per check
// (and, for 64-bit masks, a byte beside it) and the totals, in shared
// memory (ops/bp_kernel.py minsum_checks_bytes); the planes in the form
// kPlanes (_kernels.PLANE_FORMS): 0 16-bit, staged (with the shared channel
// LLRs), 1 16-bit read from device memory, 2 32-bit read from device memory
struct CheckOffsets {
  size_t edge, llr, lanes;  // staged planes (chk at 0), lane regions
  size_t meta, tot, lane;   // within a lane region (records at 0)
  __host__ __device__ CheckOffsets(int m, int n, int rw, int cw, bool wide,
                                   bool staged, bool llr_shared) {
    const size_t E = (size_t)m * rw, V = (size_t)n * cw;
    edge = staged ? align16(2 * E) : 0;
    llr = edge + (staged ? align16(2 * V) : 0);
    lanes = llr + (staged && llr_shared ? align16(4 * (size_t)n) : 0);
    meta = 16 * (size_t)m;
    tot = meta + (wide ? align16((size_t)m) : 0);
    lane = tot + align16(4 * (size_t)n);
  }
};

// A check's record: its Top2 (min1, min2, the negative signs' mask, and a
// byte that holds the slot of the first minimum in bits 0-5, the sign
// product in bit 6 and the syndrome bit in bit 7), one 16-byte load or
// store; the byte lies in the record for 32-bit masks and beside it for
// 64-bit ones.  Every c2v of the check is check_c2v of its Top2, and the
// v2c of its slot-s edge is Msg::store(gather_total(tot[v]) - that c2v):
// the check pass rebuilds both from the record it overwrites, so no
// per-edge message is kept.
template <class Mask>
struct alignas(16) Record {
  float min1, min2;
  Mask negs;
  unsigned meta;  // 32-bit masks only
};
template <>
struct alignas(16) Record<unsigned long long> {
  float min1, min2;
  unsigned long long negs;
};

template <class Mask>
struct CheckRecords {
  static constexpr bool kWide = sizeof(Mask) == 8;
  Record<Mask>* rec;
  uint8_t* meta;  // 64-bit masks only
  __device__ __forceinline__ minsum::Top2<Mask> get(int i,
                                                    bool& synd) const {
    const Record<Mask> c = rec[i];
    unsigned mt;
    if constexpr (kWide) mt = meta[i];
    else mt = c.meta;
    synd = (mt & 128u) != 0u;
    return minsum::Top2<Mask>{c.min1, c.min2, (int)(mt & 63u), c.negs,
                              (mt & 64u) != 0u};
  }
  __device__ __forceinline__ void put(int i, const minsum::Top2<Mask>& c,
                                      bool synd) const {
    const unsigned mt =
        (unsigned)c.amin | (c.neg ? 64u : 0u) | (synd ? 128u : 0u);
    if constexpr (kWide) {
      rec[i] = Record<Mask>{c.min1, c.min2, c.negs};
      meta[i] = (uint8_t)mt;
    } else {
      rec[i] = Record<Mask>{c.min1, c.min2, c.negs, mt};
    }
  }
};

// a variable's first terms, loaded together in the variable pass
constexpr int kTerms = 4;

template <class Msg, bool kWide, int kPlanes>
__global__ void __launch_bounds__(kMaxThreads, 1)
bp_minsum_checks_kernel(const uint8_t* __restrict__ synd,     // (B, m)
                        const float* __restrict__ llr,        // (n,) or (B, n)
                        int llr_per_shot,
                        const void* __restrict__ chk_g,       // (rw, m)
                        const void* __restrict__ edge_g,      // (cw, n)
                        const uint8_t* __restrict__ lens,     // (m + n,)
                        uint8_t* __restrict__ err,            // (B, n)
                        float* __restrict__ post,             // (B, n)
                        uint8_t* __restrict__ conv,           // (B,)
                        int32_t* __restrict__ iters,          // (B,)
                        int* __restrict__ next,               // claims
                        int m, int n, int rw, int cw, int B, int max_iter,
                        float scale, int tpl) {
  using Mask =
      typename std::conditional<kWide, unsigned long long, unsigned>::type;
  using G = typename std::conditional<kPlanes == 2, minsum::Planes32,
                                      minsum::Planes>::type;
  using Idx = typename G::Index;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_shot[kMaxLanes][2];
  const CheckOffsets o(m, n, rw, cw, kWide, kPlanes == 0, !llr_per_shot);
  uint16_t* chk_s = (uint16_t*)smem;
  uint16_t* edge_s = (uint16_t*)(smem + o.edge);
  float* llr_s = (float*)(smem + o.llr);
  if (kPlanes == 0) {
    const int E = m * rw, V = n * cw;
    for (int k = threadIdx.x; k < E; k += blockDim.x)
      chk_s[k] = ((const uint16_t*)chk_g)[k];
    for (int k = threadIdx.x; k < V; k += blockDim.x)
      edge_s[k] = ((const uint16_t*)edge_g)[k];
    if (!llr_per_shot)
      for (int j = threadIdx.x; j < n; j += blockDim.x) llr_s[j] = llr[j];
    __syncthreads();
  }
  const Idx* chk = kPlanes == 0 ? (const Idx*)chk_s : (const Idx*)chk_g;
  const Idx* edge = kPlanes == 0 ? (const Idx*)edge_s : (const Idx*)edge_g;
  // a plane entry: from shared memory, or through the read-only path
  auto ld = [&](const Idx* p, int k) -> int {
    if constexpr (kPlanes == 0) return (int)p[k];
    else return (int)__ldg(p + k);
  };
  // edge e's slot e / m: for 16-bit planes (e < 65,535, m < 65,535) the
  // high word of e * (floor((2^32 - 1) / m) + 1) is exact
  const unsigned magic = m > 1 ? 0xFFFFFFFFu / (unsigned)m + 1u : 0u;
  auto slot_of = [&](int e) -> int {
    if constexpr (kPlanes == 2) return e / m;
    else return m > 1 ? (int)__umulhi((unsigned)e, magic) : e;
  };
  // `lens` holds the length of each check's and each variable's list up to
  // its last live entry (ops/bp_kernel.py minsum_planes), so a walk stops
  // there: a padded slot leaves a Top2 as it is, and padded terms add
  // nothing to a bf16 total and 0 to a float32 one (a float32 walk takes
  // one padded term past its length, if the list has one, as x + 0 is
  // x + 0 + 0)
  auto slots_of = [&](int i) { return (int)__ldg(lens + i); };

  const int lane = threadIdx.x / tpl, r = threadIdx.x % tpl;
  unsigned char* mine = smem + o.lanes + lane * o.lane;
  const CheckRecords<Mask> rec{(Record<Mask>*)mine, mine + o.meta};
  float* tot = (float*)(mine + o.tot);

  auto llr0 = [&](int b, int v) {
    return llr_per_shot ? __ldg(llr + (size_t)b * n + v)
           : kPlanes == 0 ? llr_s[v]
                          : __ldg(llr + v);
  };

  for (int k = 0;; ++k) {
    // the slot alternates, so a claim never overwrites one a thread of the
    // lane may still read
    if (r == 0) s_shot[lane][k & 1] = atomicAdd(next, 1);
    minsum::lane_sync(lane, tpl);
    const int b = s_shot[lane][k & 1];
    if (b >= B) return;
    uint8_t* err_b = err + (size_t)b * n;
    float* post_b = post + (size_t)b * n;
    if (max_iter == 0) {
      for (int j = r; j < n; j += tpl) {
        err_b[j] = 0;
        post_b[j] = llr0(b, j);
      }
      if (r == 0) {
        conv[b] = 0;
        iters[b] = 0;
      }
      continue;
    }
    const uint8_t* synd_b = synd + (size_t)b * m;
    // iteration 1's check update, from the channel LLRs
    for (int i = r; i < m; i += tpl) {
      const bool sb = synd_b[i] != 0;
      rec.put(i,
              minsum::check_top2<Mask>(slots_of(i), sb, [&](int s, float& x) {
                const int v = ld(chk, s * m + i);
                if (v == G::kPad) return false;
                x = Msg::load(Msg::store(llr0(b, v)));
                return true;
              }),
              sb);
    }
    // minsum_body.cuh lane_decode's two lane barriers an iteration, with
    // each c2v rebuilt from its check's record
    int it = 0;
    bool bad;
    for (;;) {
      minsum::lane_sync(lane, tpl);
      for (int j = r; j < n; j += tpl) {
        const int live = __ldg(lens + m + j);
        // the first kTerms entries of the variable's list, loaded at once
        // (one wait for the memory where one a term would wait each)
        int first[kTerms];
#pragma unroll
        for (int u = 0; u < kTerms; ++u)
          first[u] = u < live ? ld(edge, u * n + j) : G::kPad;
        tot[j] = minsum::var_total<Msg>(
            llr0(b, j), Msg::kBf16 ? live : min(live + 1, cw),
            [&](int t, float& c, int& s) {
              if (t >= live) return false;
              int e = t < kTerms ? first[0] : ld(edge, t * n + j);
#pragma unroll
              for (int u = 1; u < kTerms; ++u)
                if (t == u) e = first[u];
              if (e == G::kPad) return false;
              bool sb;
              s = slot_of(e);
              c = minsum::check_c2v(rec.get(e - s * m, sb), s, scale);
              return true;
            });
      }
      ++it;
      minsum::lane_sync(lane, tpl);
      // each check's parity of these totals and, unless this was the last
      // iteration, its next check update from its v2c (the totals less its
      // record's c2v), in one walk over its slots
      bool fail = false;
      for (int i = r; i < m; i += tpl) {
        bool sb;
        const minsum::Top2<Mask> old = rec.get(i, sb);
        const int len = slots_of(i);
        unsigned par = sb;
        if (it < max_iter) {
          rec.put(i,
                  minsum::check_top2<Mask>(len, sb, [&](int s, float& x) {
                    const int v = ld(chk, s * m + i);
                    if (v == G::kPad) return false;
                    const float t_v = minsum::gather_total<Msg>(tot[v]);
                    par ^= t_v < 0.f;
                    x = Msg::load(
                        Msg::store(t_v - minsum::check_c2v(old, s, scale)));
                    return true;
                  }),
                  sb);
        } else {
          for (int s = 0; s < len; ++s) {
            const int v = ld(chk, s * m + i);
            if (v != G::kPad) par ^= minsum::gather_total<Msg>(tot[v]) < 0.f;
          }
        }
        fail |= (par & 1u) != 0u;
      }
      bad = minsum::lane_sync_or(lane, tpl, fail);
      if (!bad || it == max_iter) break;
    }
    // the totals of the last iteration, each read by the thread that wrote it
    for (int j = r; j < n; j += tpl) {
      const float t = tot[j];
      err_b[j] = t < 0.f ? 1 : 0;
      post_b[j] = t;
    }
    if (r == 0) {
      conv[b] = bad ? 0 : 1;
      iters[b] = bad ? max_iter : it;
    }
  }
}

template <class Msg, int kMem, bool kWide>
int set_smem(int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(bp_minsum_kernel<Msg, kMem, kWide>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

template <class Msg, int kMem, bool kWide>
int launch_mem(const uint8_t* synd, const float* llr0, int llr_per_shot,
               const uint16_t* chk, const uint16_t* edge, const uint8_t* slot,
               uint8_t* err, float* post, uint8_t* conv, int32_t* iters,
               int* next, int m, int n, int rw, int cw, int B, int max_iter,
               float scale, int lanes, int tpl, int grid, int smem_bytes,
               unsigned char* lanes_g, int n_sec, const int* sec_off,
               void* stream) {
  constexpr int kMaxRw = kWide ? minsum::kMaxRowWeight
                                : minsum::mask_slots<unsigned>();
  const Offsets o(m, n, rw, cw, sizeof(typename Msg::T), Msg::kBf16,
                  !llr_per_shot);
  // the shared memory each mode stages
  const long long need = kMem == 0 ? (long long)(o.lanes + lanes * o.lane)
                         : kMem == 1 ? (long long)o.lanes
                                     : 0;
  if (lanes < 1 || lanes > kMaxLanes || tpl < 32 || tpl % 32 != 0 ||
      lanes * tpl > kMaxThreads || rw < 1 || rw > kMaxRw || grid < 1 ||
      smem_bytes < need || (kMem > 0 && lanes_g == nullptr) || n_sec < 1 ||
      (n_sec > 1 && sec_off == nullptr) || (long long)B * n_sec >= (1LL << 31))
    return -1;
  const int e = set_smem<Msg, kMem, kWide>(smem_bytes);
  if (e != 0) return e;
  bp_minsum_kernel<Msg, kMem, kWide>
      <<<grid, lanes * tpl, smem_bytes, (cudaStream_t)stream>>>(
          synd, llr0, llr_per_shot, chk, edge, slot, err, post, conv, iters,
          next, m, n, rw, cw, B, max_iter, scale, tpl, lanes_g, n_sec,
          sec_off);
  return (int)cudaGetLastError();
}

template <class Msg, bool kWide, int kPlanes>
int set_smem_checks(int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      bp_minsum_checks_kernel<Msg, kWide, kPlanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <class Msg, bool kWide, int kPlanes>
int launch_checks(const uint8_t* synd, const float* llr0, int llr_per_shot,
                  const void* chk, const void* edge, const uint8_t* lens,
                  uint8_t* err,
                  float* post, uint8_t* conv, int32_t* iters, int* next,
                  int m, int n, int rw, int cw, int B, int max_iter,
                  float scale, int lanes, int tpl, int grid, int smem_bytes,
                  void* stream) {
  constexpr int kMaxRw = kWide ? minsum::kMaxRowWeight
                                : minsum::mask_slots<unsigned>();
  const CheckOffsets o(m, n, rw, cw, kWide, kPlanes == 0, !llr_per_shot);
  // 16-bit planes number edges and variables below 0xFFFF
  const bool narrow = (long long)m * rw < minsum::kPad && n < minsum::kPad;
  if (lanes < 1 || lanes > kMaxLanes || tpl < 32 || tpl % 32 != 0 ||
      lanes * tpl > kMaxThreads || rw < 1 || rw > kMaxRw || grid < 1 ||
      smem_bytes < (long long)(o.lanes + lanes * o.lane) ||
      (kPlanes < 2 && !narrow) || cw > 254 || lens == nullptr)
    return -1;
  const int e = set_smem_checks<Msg, kWide, kPlanes>(smem_bytes);
  if (e != 0) return e;
  bp_minsum_checks_kernel<Msg, kWide, kPlanes>
      <<<grid, lanes * tpl, smem_bytes, (cudaStream_t)stream>>>(
          synd, llr0, llr_per_shot, chk, edge, lens, err, post, conv, iters,
          next, m, n, rw, cw, B, max_iter, scale, tpl);
  return (int)cudaGetLastError();
}

// mem 0: the shared-memory mode; 1 and 2: the device-memory modes, lanes
// in `lanes_g` (chk and edge then 32-bit planes in mode 2); 3: the
// check-state mode, its planes in the form `planes` (CheckOffsets); the
// wide instance for row weights above 32
template <class Msg>
int launch(const uint8_t* synd, const float* llr0, int llr_per_shot,
           const uint16_t* chk, const uint16_t* edge, const uint8_t* slot,
           uint8_t* err, float* post, uint8_t* conv, int32_t* iters,
           int* next, int m, int n, int rw, int cw, int B, int max_iter,
           float scale, int lanes, int tpl, int grid, int smem_bytes, int mem,
           int planes, const uint8_t* lens, unsigned char* lanes_g,
           int n_sec, const int* sec_off, void* stream) {
#define BP_MINSUM_CHECKS(WIDE, PLANES)                                  \
  return launch_checks<Msg, WIDE, PLANES>(                              \
      synd, llr0, llr_per_shot, chk, edge, lens, err, post, conv, iters, \
      next, m, n, rw, cw, B, max_iter, scale, lanes, tpl, grid,         \
      smem_bytes, stream)
#define BP_MINSUM_LAUNCH(MEM, WIDE)                                     \
  return launch_mem<Msg, MEM, WIDE>(                                    \
      synd, llr0, llr_per_shot, chk, edge, slot, err, post, conv, iters, \
      next, m, n, rw, cw, B, max_iter, scale, lanes, tpl, grid,          \
      smem_bytes, lanes_g, n_sec, sec_off, stream)
  const bool wide = rw > minsum::mask_slots<unsigned>();
  if (mem == 3) {
    // the check-state mode decodes whole graphs only
    if (n_sec != 1) return -1;
    switch (planes * 2 + wide) {
      case 0: BP_MINSUM_CHECKS(false, 0);
      case 1: BP_MINSUM_CHECKS(true, 0);
      case 2: BP_MINSUM_CHECKS(false, 1);
      case 3: BP_MINSUM_CHECKS(true, 1);
      case 4: BP_MINSUM_CHECKS(false, 2);
      case 5: BP_MINSUM_CHECKS(true, 2);
      default: return -1;
    }
  }
  switch (mem * 2 + wide) {
    case 0: BP_MINSUM_LAUNCH(0, false);
    case 1: BP_MINSUM_LAUNCH(0, true);
    case 2: BP_MINSUM_LAUNCH(1, false);
    case 3: BP_MINSUM_LAUNCH(1, true);
    case 4: BP_MINSUM_LAUNCH(2, false);
    case 5: BP_MINSUM_LAUNCH(2, true);
    default: return -1;
  }
#undef BP_MINSUM_LAUNCH
#undef BP_MINSUM_CHECKS
}

template <class Msg, int kMem, bool kWide>
int resident_mem(int threads, int smem_bytes, int* blocks) {
  const int e = set_smem<Msg, kMem, kWide>(smem_bytes);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, bp_minsum_kernel<Msg, kMem, kWide>, threads, smem_bytes);
}

template <class Msg, bool kWide, int kPlanes>
int resident_checks(int threads, int smem_bytes, int* blocks) {
  const int e = set_smem_checks<Msg, kWide, kPlanes>(smem_bytes);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, bp_minsum_checks_kernel<Msg, kWide, kPlanes>, threads,
      smem_bytes);
}

template <class Msg>
int resident(int threads, int smem_bytes, int mem, int planes, int wide,
             int* blocks) {
  if (mem == 3) {
    switch (planes * 2 + (wide != 0)) {
      case 0: return resident_checks<Msg, false, 0>(threads, smem_bytes, blocks);
      case 1: return resident_checks<Msg, true, 0>(threads, smem_bytes, blocks);
      case 2: return resident_checks<Msg, false, 1>(threads, smem_bytes, blocks);
      case 3: return resident_checks<Msg, true, 1>(threads, smem_bytes, blocks);
      case 4: return resident_checks<Msg, false, 2>(threads, smem_bytes, blocks);
      case 5: return resident_checks<Msg, true, 2>(threads, smem_bytes, blocks);
      default: return -1;
    }
  }
  switch (mem * 2 + (wide != 0)) {
    case 0: return resident_mem<Msg, 0, false>(threads, smem_bytes, blocks);
    case 1: return resident_mem<Msg, 0, true>(threads, smem_bytes, blocks);
    case 2: return resident_mem<Msg, 1, false>(threads, smem_bytes, blocks);
    case 3: return resident_mem<Msg, 1, true>(threads, smem_bytes, blocks);
    case 4: return resident_mem<Msg, 2, false>(threads, smem_bytes, blocks);
    case 5: return resident_mem<Msg, 2, true>(threads, smem_bytes, blocks);
    default: return -1;
  }
}

}  // namespace

extern "C" int bp_minsum_launch(const uint8_t* synd, const float* llr0,
                                int llr_per_shot, const uint16_t* chk,
                                const uint16_t* edge, uint8_t* err,
                                float* post, uint8_t* conv, int32_t* iters,
                                int* next, int m, int n, int rw, int cw, int B,
                                int max_iter, float scale, int lanes, int tpl,
                                int grid, int smem_bytes, int mem,
                                int planes, const uint8_t* lens,
                                unsigned char* lanes_g, void* stream) {
  return launch<minsum::F32Msg>(synd, llr0, llr_per_shot, chk, edge, nullptr,
                                err, post, conv, iters, next, m, n, rw, cw, B,
                                max_iter, scale, lanes, tpl, grid, smem_bytes,
                                mem, planes, lens, lanes_g, 1, nullptr,
                                stream);
}

// kernel 1's sector mode: a block-diagonal graph of n_sec sectors, sector
// s its checks [sec_off[s], sec_off[s + 1]) and variables
// [sec_off[n_sec + 1 + s], sec_off[n_sec + 2 + s]); the claims hand out
// (shot, sector) items b * n_sec + s, and conv and iters are per item,
// (B, n_sec).  The shared-memory and device-memory modes (mem 0-2).
extern "C" int bp_minsum_sectors_launch(
    const uint8_t* synd, const float* llr0, int llr_per_shot,
    const uint16_t* chk, const uint16_t* edge, uint8_t* err, float* post,
    uint8_t* conv, int32_t* iters, int* next, int m, int n, int rw, int cw,
    int B, int max_iter, float scale, int lanes, int tpl, int grid,
    int smem_bytes, int mem, int planes, const uint8_t* lens,
    unsigned char* lanes_g, int n_sec, const int* sec_off, void* stream) {
  return launch<minsum::F32Msg>(synd, llr0, llr_per_shot, chk, edge, nullptr,
                                err, post, conv, iters, next, m, n, rw, cw, B,
                                max_iter, scale, lanes, tpl, grid, smem_bytes,
                                mem, planes, lens, lanes_g, n_sec, sec_off,
                                stream);
}

// the bf16 head: one channel-LLR vector shared by the shots
extern "C" int bp_minsum_bf16_launch(const uint8_t* synd, const float* llr0,
                                     const uint16_t* chk,
                                     const uint16_t* edge,
                                     const uint8_t* slot, uint8_t* err,
                                     float* post, uint8_t* conv,
                                     int32_t* iters, int* next, int m, int n,
                                     int rw, int cw, int B, int max_iter,
                                     float scale, int lanes, int tpl,
                                     int grid, int smem_bytes, int mem,
                                     int planes, const uint8_t* lens,
                                     unsigned char* lanes_g, void* stream) {
  return launch<minsum::Bf16Msg>(synd, llr0, 0, chk, edge, slot, err, post,
                                 conv, iters, next, m, n, rw, cw, B, max_iter,
                                 scale, lanes, tpl, grid, smem_bytes, mem,
                                 planes, lens, lanes_g, 1, nullptr, stream);
}

// blocks of `threads` threads and `smem_bytes` of shared memory that one SM
// holds at once in memory mode `mem` (plane form `planes` in mode 3), of
// the wide instance with `wide`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
extern "C" int bp_minsum_resident(int bf16, int threads, int smem_bytes,
                                  int mem, int planes, int wide,
                                  int* blocks) {
  return bf16 ? resident<minsum::Bf16Msg>(threads, smem_bytes, mem, planes,
                                          wide, blocks)
              : resident<minsum::F32Msg>(threads, smem_bytes, mem, planes,
                                         wide, blocks);
}
