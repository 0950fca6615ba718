// The whole code-capacity pipeline of a batch in one kernel, bf16 messages:
// counter-PRNG sample, both syndromes, both sectors' min-sum decodes,
// residual checks.
//
// Replaces the bf16 mode of the TPU kernel _fused_decode_kernel
// (qldpc_fault_tolerance_tpu/ops/gf2_pallas.py:628, quantize=None), which
// runs the same pipeline on a VMEM tile with dense f32 MXU products for
// GF(2) and the bf16 loop _minsum_plane_loop
// (qldpc_fault_tolerance_tpu/ops/bp_pallas.py:227) with one-hot MXU
// products for its gathers and scatters.  Here GF(2) products are gathers
// through the checks' planes, and each decode is minsum_body.cuh's per-shot
// loop in its Bf16Msg format, the loop the bf16 head (bp_minsum.cu) runs;
// the int8 mode is fused_decode_int8.cu.
//
// Function: ops/gf2_kernel.py fused_decode_stats (quantize=None), plain
// version fused_decode_plain.  For each shot s < B: the errors of
// sample_syndrome (Threefry at counters (s, v), the key read from device
// memory), syndromes synd_z = hx . e_z and synd_x = hz . e_x, the Z
// sector's then the X sector's min-sum decode with bf16 v2c
// (ops/bp_kernel.py minsum_dense_plain: each shot frozen at its first
// convergence, max_iter_z / max_iter_x iterations at most), residuals
// r = e ^ correction and the checks of gf2_residual.cu.  Outputs: each
// shot's converged flag and iterations for both sectors, and per block
// (failures, min weight) in a (blocks, 2) partial table that the wrapper
// reduces by sum and min.  Shots are independent in this mode, so the JAX
// tile's early exit (when all its shots have converged) changes no output.
//
// Design: the bf16 head's lanes carried over to the whole pipeline.  A
// block holds `lanes` shots at a time; each lane is `tpl` threads (whole
// warps) with its own named barrier.  A lane claims shot s from a device
// counter (atomicAdd; the wrapper zeroes it), draws the shot's errors into
// shared memory, decodes the Z sector from the syndrome of e_z (computed
// in the first check pass), XORs the correction into e_z, does the same
// for the X sector, runs the four residual checks and the weights (a warp
// reduction, then shared atomics), writes the shot's flags and iterations,
// and claims the next shot; at its next claim it folds the last shot's
// (fail, weight) into the block's partial.  The block leaves when the
// counter passes the batch; its partial is written once.  Sum and min are
// order-free, so the order of the claims changes no bit.  The wrapper
// launches what the card holds at once (ops/gf2_kernel.py fused_layout, the
// min-sum kernels' rule).  Per shot: 2 lane barriers per iteration of each
// sector, 3 more (claim, sample, residuals).
//
// Shared memory: both sectors' graphs, staged once from the host-built
// planes of their heads (ops/bp_kernel.py minsum_planes: 2 * rw * m bytes of
// check slots, 2 * cw * n of variable edges, cw * n of their slots) and
// channel LLRs (4 * n); then per lane c2v (4 per edge) and v2c (2 per edge)
// of the larger sector, the totals (4 * n), the syndrome (the larger m) and
// both error planes (2 * n); each piece rounded up to 16 bytes (mirrored by
// ops/gf2_kernel.py fused_smem_bytes).  At hgp_34_n625: 28,480 B staged and
// 16,704 B per shot.  Device memory sees the staged planes read once per
// block, the logical checks read per shot, and each shot's four outputs
// written once.  Built with -fmad=false, as the plain version rounds.
//
// Row weights: the decode's slot masks are 32-bit up to row weight 32; the
// wide instance (kWide, a template flag whose false value is the 32-bit
// code) takes 64-bit masks (minsum_body.cuh Top2) and row weights up to
// 64 in either sector.  The launcher picks it from the row weights.
//
// Bound: per live shot-iteration the decode's passes (as bp_minsum.cu),
// plus one Threefry draw per (shot, qubit); the iterations are
// latency-bound chains of shared-memory passes between lane barriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "counter_gf2.cuh"
#include "minsum_body.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLanes = minsum::kMaxLanes;

using counter_gf2::Adjacency;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// one sector's planes in device memory (ops/bp_kernel.py minsum_planes of
// its head) and its channel LLRs
struct Sector {
  const uint16_t* chk;   // (rw, m)
  const uint16_t* edge;  // (cw, n)
  const uint8_t* slot;   // (cw, n)
  const float* llr;      // (n,)
  int m, rw, cw;
};

// byte offsets in dynamic shared memory (mirrored by ops/gf2_kernel.py
// fused_smem_bytes), from n and the Z and the X sector's m, rw, cw
struct Offsets {
  size_t z[4], x[4];  // each sector's staged chk, edge, slot, llr
  size_t lanes;       // the lane regions
  size_t v2c, tot, syn, ex, ez, lane;  // within one (c2v at 0); its size
  __host__ __device__ Offsets(int n, int m_z, int rw_z, int cw_z, int m_x,
                              int rw_x, int cw_x) {
    size_t at = 0;
    place(z, at, m_z, rw_z, cw_z, n);
    place(x, at, m_x, rw_x, cw_x, n);
    lanes = at;
    const size_t e_z = (size_t)m_z * rw_z, e_x = (size_t)m_x * rw_x;
    const size_t E = e_z > e_x ? e_z : e_x;
    v2c = align16(4 * E);
    tot = v2c + align16(2 * E);
    syn = tot + align16(4 * (size_t)n);
    ex = syn + align16((size_t)(m_z > m_x ? m_z : m_x));
    ez = ex + align16((size_t)n);
    lane = ez + align16((size_t)n);
  }
  __host__ __device__ static void place(size_t* o, size_t& at, int m, int rw,
                                        int cw, int n) {
    o[0] = at;
    at += align16(2 * (size_t)rw * m);
    o[1] = at;
    at += align16(2 * (size_t)cw * n);
    o[2] = at;
    at += align16((size_t)cw * n);
    o[3] = at;
    at += align16(4 * (size_t)n);
  }
};

// copy a sector's planes and LLRs into shared memory at `o`, with every
// thread of the block; the caller synchronises
__device__ minsum::Planes stage(const Sector& s, unsigned char* smem,
                                const size_t* o, int n, const float** llr) {
  uint16_t* chk = (uint16_t*)(smem + o[0]);
  uint16_t* edge = (uint16_t*)(smem + o[1]);
  uint8_t* slot = smem + o[2];
  float* llr_s = (float*)(smem + o[3]);
  for (int k = threadIdx.x; k < s.m * s.rw; k += blockDim.x) chk[k] = s.chk[k];
  for (int k = threadIdx.x; k < n * s.cw; k += blockDim.x) {
    edge[k] = s.edge[k];
    slot[k] = s.slot[k];
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) llr_s[j] = s.llr[j];
  *llr = llr_s;
  return minsum::Planes{chk, edge, slot, s.m, n, s.rw, s.cw};
}

// parity of check i of g on one shot's bits
__device__ __forceinline__ unsigned plane_parity(const minsum::Planes& g,
                                                 int i, const uint8_t* bits) {
  unsigned par = 0u;
  for (int s = 0; s < g.rw; ++s) {
    const int v = g.chk[s * g.m + i];
    if (v != minsum::kPad) par ^= bits[v];
  }
  return par & 1u;
}

template <bool kWide>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_decode_kernel(const uint32_t* __restrict__ key, counter_gf2::Cuts cuts,
                    Sector sz,  // of hx: decodes synd_z
                    Sector sx,  // of hz: decodes synd_x
                    Adjacency lx, Adjacency lz, int n, int max_iter_z,
                    int max_iter_x, float scale, int eval_code, int B,
                    int tpl, uint8_t* __restrict__ conv_z,
                    int32_t* __restrict__ iter_z,
                    uint8_t* __restrict__ conv_x,
                    int32_t* __restrict__ iter_x,
                    int32_t* __restrict__ part,  // (blocks, 2)
                    int* __restrict__ next) {    // claims, 0 at launch
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_shot[kMaxLanes][2];
  // per lane, its last shot's residual flags (bits: hz and lz on r_x, hx
  // and lx on r_z) and weights |r_x|, |r_z|
  __shared__ int s_res[kMaxLanes][3];
  __shared__ int s_fail, s_minw;  // the block's partial
  const Offsets o(n, sz.m, sz.rw, sz.cw, sx.m, sx.rw, sx.cw);
  const float *llr_z, *llr_x;
  const minsum::Planes gz = stage(sz, smem, o.z, n, &llr_z);
  const minsum::Planes gx = stage(sx, smem, o.x, n, &llr_x);
  for (int k = threadIdx.x; k < kMaxLanes * 3; k += blockDim.x)
    (&s_res[0][0])[k] = 0;
  if (threadIdx.x == 0) {
    s_fail = 0;
    s_minw = n;
  }
  __syncthreads();

  const int lane = threadIdx.x / tpl, r = threadIdx.x % tpl;
  unsigned char* mine = smem + o.lanes + lane * o.lane;
  float* c2v = (float*)mine;
  __nv_bfloat16* v2c = (__nv_bfloat16*)(mine + o.v2c);
  float* tot = (float*)(mine + o.tot);
  uint8_t* syn = mine + o.syn;
  uint8_t* ex = mine + o.ex;  // X errors, then r_x
  uint8_t* ez = mine + o.ez;  // Z errors, then r_z

  // one sector of shot b: decode the syndrome of `err` over g's checks,
  // err ^= correction, the shot's flag and iterations written
  auto sector = [&](const minsum::Planes& g, const float* llr, uint8_t* err,
                    int max_iter, uint8_t* conv, int32_t* iters, int b) {
    int it = 0;
    bool bad = true;
    if (max_iter > 0) {
      using Mask =
          typename std::conditional<kWide, unsigned long long, unsigned>::type;
      bad = minsum::lane_decode<minsum::Bf16Msg, Mask>(
          g, [&](int i) { return (uint8_t)plane_parity(g, i, err); },
          [&](int j) { return llr[j]; }, c2v, v2c, tot, syn, max_iter, scale,
          lane, r, tpl, it);
      for (int j = r; j < n; j += tpl) err[j] ^= tot[j] < 0.f ? 1 : 0;
    }
    if (r == 0) {
      conv[b] = bad ? 0 : 1;
      iters[b] = bad ? max_iter : it;
    }
  };

  for (int k = 0;; ++k) {
    // the slot alternates, so a claim never overwrites one a thread of the
    // lane may still read
    if (r == 0) s_shot[lane][k & 1] = atomicAdd(next, 1);
    minsum::lane_sync(lane, tpl);
    if (r == 0 && k > 0) {  // fold the lane's last shot into the partial
      const int f = s_res[lane][0];
      const bool x_fail = (f & 3) != 0, z_fail = (f & 12) != 0;
      const bool fail =
          eval_code == 0 ? x_fail : (eval_code == 1 ? z_fail : x_fail || z_fail);
      if (fail) atomicAdd(&s_fail, 1);
      int w = n;
      if (f & 2) w = min(w, s_res[lane][1]);
      if (f & 8) w = min(w, s_res[lane][2]);
      if (w < n) atomicMin(&s_minw, w);
      s_res[lane][0] = s_res[lane][1] = s_res[lane][2] = 0;
    }
    const int b = s_shot[lane][k & 1];
    if (b >= B) break;

    const uint32_t k0 = counter_gf2::key_word(key, 0);
    const uint32_t k1 = counter_gf2::key_word(key, 1);
    for (int j = r; j < n; j += tpl) {
      bool bx = false, bz = false;
      counter_gf2::depolarize(
          counter_gf2::draw(k0, k1, (uint32_t)b, (uint32_t)j), cuts, bx, bz);
      ex[j] = bx;
      ez[j] = bz;
    }
    minsum::lane_sync(lane, tpl);
    sector(gz, llr_z, ez, max_iter_z, conv_z, iter_z, b);
    sector(gx, llr_x, ex, max_iter_x, conv_x, iter_x, b);
    minsum::lane_sync(lane, tpl);

    // residual checks: hz and lz on r_x, hx and lx on r_z; the weights
    unsigned flags = 0u;
    int wx = 0, wz = 0;
    for (int i = r; i < gx.m; i += tpl) flags |= plane_parity(gx, i, ex);
    for (int i = r; i < lz.rows; i += tpl)
      if (counter_gf2::parity_row(lz.nbr, lz.mask, lz.rw, i, ex, 1, 0)) flags |= 2u;
    for (int i = r; i < gz.m; i += tpl) flags |= plane_parity(gz, i, ez) << 2;
    for (int i = r; i < lx.rows; i += tpl)
      if (counter_gf2::parity_row(lx.nbr, lx.mask, lx.rw, i, ez, 1, 0)) flags |= 8u;
    for (int j = r; j < n; j += tpl) {
      wx += ex[j];
      wz += ez[j];
    }
    flags = __reduce_or_sync(0xffffffffu, flags);
    wx = __reduce_add_sync(0xffffffffu, wx);
    wz = __reduce_add_sync(0xffffffffu, wz);
    if ((r & 31) == 0) {
      if (flags) atomicOr(&s_res[lane][0], (int)flags);
      if (wx) atomicAdd(&s_res[lane][1], wx);
      if (wz) atomicAdd(&s_res[lane][2], wz);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = s_fail;
    part[2 * blockIdx.x + 1] = s_minw;
  }
}

template <bool kWide>
int set_smem(int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fused_decode_kernel<kWide>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

// whether either sector's rows need the wide instance (64-bit slot masks)
bool wide_rows(int rwz, int rwx) {
  return rwz > minsum::mask_slots<unsigned>() ||
         rwx > minsum::mask_slots<unsigned>();
}

}  // namespace

extern "C" int fused_decode_launch(
    const uint32_t* key, uint32_t cz, uint32_t czx, uint32_t czxy,
    const uint16_t* z_chk, const uint16_t* z_edge, const uint8_t* z_slot,
    const float* llr_z, int mx, int rwz, int cwz,
    const uint16_t* x_chk, const uint16_t* x_edge, const uint8_t* x_slot,
    const float* llr_x, int mz, int rwx, int cwx,
    const int32_t* lx_nbr, const uint8_t* lx_mask, int kx, int rlx,
    const int32_t* lz_nbr, const uint8_t* lz_mask, int kz, int rlz, int n,
    int max_iter_z, int max_iter_x, float scale, int eval_code, int B,
    int lanes, int tpl, int grid, int smem_bytes, uint8_t* conv_z,
    int32_t* iter_z, uint8_t* conv_x, int32_t* iter_x, int32_t* part,
    int* next, void* stream) {
  const Offsets o(n, mx, rwz, cwz, mz, rwx, cwx);
  if (lanes < 1 || lanes > kMaxLanes || tpl < 32 || tpl % 32 != 0 ||
      lanes * tpl > kMaxThreads || rwz < 1 || rwz > minsum::kMaxRowWeight ||
      rwx < 1 || rwx > minsum::kMaxRowWeight || grid < 1 ||
      (size_t)smem_bytes < o.lanes + lanes * o.lane)
    return -1;
  const bool wide = wide_rows(rwz, rwx);
  const int e = wide ? set_smem<true>(smem_bytes) : set_smem<false>(smem_bytes);
  if (e != 0) return e;
  const Sector sz{z_chk, z_edge, z_slot, llr_z, mx, rwz, cwz};
  const Sector sx{x_chk, x_edge, x_slot, llr_x, mz, rwx, cwx};
  const counter_gf2::Cuts cuts{cz, czx, czxy};
  auto kernel = wide ? fused_decode_kernel<true> : fused_decode_kernel<false>;
  kernel<<<grid, lanes * tpl, smem_bytes, (cudaStream_t)stream>>>(
      key, cuts, sz, sx, Adjacency{lx_nbr, lx_mask, kx, rlx},
      Adjacency{lz_nbr, lz_mask, kz, rlz}, n, max_iter_z, max_iter_x, scale,
      eval_code, B, tpl, conv_z, iter_z, conv_x, iter_x, part, next);
  return (int)cudaGetLastError();
}

// blocks of `threads` threads and `smem_bytes` of shared memory that one SM
// holds at once, of the wide instance with `wide`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
extern "C" int fused_decode_resident(int threads, int smem_bytes, int wide,
                                     int* blocks) {
  const int e = wide ? set_smem<true>(smem_bytes) : set_smem<false>(smem_bytes);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wide ? fused_decode_kernel<true> : fused_decode_kernel<false>,
      threads, smem_bytes);
}
