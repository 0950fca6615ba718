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
// through the checks' adjacency, and the decode is minsum_body.cuh's loop in
// its Bf16Msg format (the per-check and per-variable arithmetic that
// bp_minsum.cu shares), the one-hot products written as gathers; its int8
// mode is fused_decode_int8.cu.
//
// Function: ops/gf2_kernel.py fused_decode_stats (quantize=None), plain
// version fused_decode_plain.  For each shot s < B: the errors of
// sample_syndrome (Threefry at counters (s, v)), syndromes synd_z = hx . e_z
// and synd_x = hz . e_x, the Z sector's then the X sector's min-sum decode
// with bf16 v2c (ops/bp_kernel.py minsum_dense_plain: each shot frozen at its
// first convergence, max_iter_z / max_iter_x iterations at most), residuals
// r = e ^ correction and the checks of gf2_residual.cu.  Outputs: each
// shot's converged flag and iterations for both sectors, and per block
// (failures, min weight) in a (blocks, 2) partial table that the wrapper
// reduces.  Shots are independent in this mode, so the JAX tile's early
// exit (when all its shots have converged) changes no output; a block leaves
// its loop when its own shots have converged.
//
// Design: a block owns `lanes` shots (8 at n = 625; fewer when the larger
// sector's messages would not fit; B is a multiple of lanes, as the
// wrapper's tile of 32 shots is) and 1024 threads, thread t working for
// shot t % lanes on row t / lanes (minsum_body.cuh decode).  Shared memory
// holds one sector's messages (float32 c2v and bf16 v2c, 6 bytes per edge per
// shot, reused by the second sector), the hard decisions, both error planes
// and one syndrome plane as bytes, [index * lanes + lane].  The errors
// become residuals in place once each sector's decode ends.  Nothing but the
// per-shot flags and the block's two numbers reaches device memory.  The
// graphs' variable lists come sorted by slot, then check (the bf16 scatter
// order).  Built with -fmad=false, as the plain version rounds.
//
// Bound: per live shot-iteration the decode's passes (as bp_minsum.cu),
// plus one Threefry draw per (shot, qubit); the iterations are
// latency-bound chains of shared-memory passes between barriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_gf2.cuh"
#include "minsum_body.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLanes = minsum::kMaxLanes;

using counter_gf2::Adjacency;

// syndrome bits in shared memory, one channel LLR per variable for all shots
struct SharedIo {
  const uint8_t* bits;  // syndrome at [i * lanes + lane]
  const float* llr;     // (n,)
  int lanes, lane;
  __device__ uint8_t synd(int i) const { return bits[i * lanes + lane]; }
  __device__ float llr0(int j) const { return llr[j]; }
};

// one sector: syndrome of `err` over g's checks, decode, err ^= correction
__device__ void sector(const minsum::Graph& g, const float* llr, uint8_t* err,
                       uint8_t* synd, __nv_bfloat16* v2c, float* c2v,
                       uint8_t* hard,
                       minsum::LaneState st, int lanes, int lane, int row,
                       int rows, int max_iter, float scale,
                       uint8_t* conv, int32_t* iters, int b) {
  for (int i = row; i < g.m; i += rows)
    synd[i * lanes + lane] = counter_gf2::parity_row(g.chk_nbr, g.chk_mask,
                                                     g.rw, i, err, lanes, lane);
  __syncthreads();
  SharedIo io{synd, llr, lanes, lane};
  minsum::decode<minsum::Bf16Msg>(g, io, v2c, c2v, hard, st, lanes, lane, row,
                                  rows, true, max_iter, scale);
  if (row == 0) {
    conv[b] = st.done[lane] ? 1 : 0;
    iters[b] = st.iters[lane];
  }
  for (int j = row; j < g.n; j += rows) err[j * lanes + lane] ^= hard[j * lanes + lane] & 1;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(uint32_t k0, uint32_t k1, counter_gf2::Cuts cuts,
                    minsum::Graph gz,  // Tanner graph of hx: decodes synd_z
                    minsum::Graph gx,  // Tanner graph of hz: decodes synd_x
                    Adjacency lx, Adjacency lz,
                    const float* __restrict__ llr_z,  // (n,)
                    const float* __restrict__ llr_x,  // (n,)
                    int max_iter_z, int max_iter_x, float scale,
                    int eval_code, int lanes,
                    uint8_t* __restrict__ conv_z, int32_t* __restrict__ iter_z,
                    uint8_t* __restrict__ conv_x, int32_t* __restrict__ iter_x,
                    int32_t* __restrict__ part) {  // (blocks, 2)
  extern __shared__ float smem[];
  __shared__ int s_done[kMaxLanes];
  __shared__ int s_bad[kMaxLanes];
  __shared__ int s_iters[kMaxLanes];
  // x_stab, x_log, z_stab, z_log per shot, then residual weights
  __shared__ int s_flags[kMaxLanes][4];
  __shared__ int s_wx[kMaxLanes];
  __shared__ int s_wz[kMaxLanes];
  const int n = gz.n;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = kThreads / lanes;
  const int b = blockIdx.x * lanes + lane;
  const int E = max(gz.m * gz.rw, gx.m * gx.rw);
  float* c2v = smem;                                     // [e * lanes + lane]
  __nv_bfloat16* v2c = (__nv_bfloat16*)(c2v + (size_t)E * lanes);
  uint8_t* hard = (uint8_t*)(v2c + (size_t)E * lanes);  // [j * lanes + lane]
  uint8_t* ex = hard + (size_t)n * lanes;                // X errors, then r_x
  uint8_t* ez = ex + (size_t)n * lanes;                  // Z errors, then r_z
  uint8_t* synd = ez + (size_t)n * lanes;                // [i * lanes + lane]
  const minsum::LaneState st{s_done, s_bad, s_iters};

  if (row == 0) {
    for (int k = 0; k < 4; ++k) s_flags[lane][k] = 0;
    s_wx[lane] = 0;
    s_wz[lane] = 0;
  }
  for (int j = row; j < n; j += rows) {
    bool bx = false, bz = false;
    counter_gf2::depolarize(counter_gf2::draw(k0, k1, (uint32_t)b, (uint32_t)j),
                            cuts, bx, bz);
    ex[j * lanes + lane] = bx;
    ez[j * lanes + lane] = bz;
  }
  __syncthreads();

  sector(gz, llr_z, ez, synd, v2c, c2v, hard, st, lanes, lane, row, rows,
         max_iter_z, scale, conv_z, iter_z, b);
  sector(gx, llr_x, ex, synd, v2c, c2v, hard, st, lanes, lane, row, rows,
         max_iter_x, scale, conv_x, iter_x, b);

  // residual checks: hz and lz on r_x, hx and lx on r_z
  const Adjacency hz{gx.chk_nbr, gx.chk_mask, gx.m, gx.rw};
  const Adjacency hx{gz.chk_nbr, gz.chk_mask, gz.m, gz.rw};
  const Adjacency checks[4] = {hz, lz, hx, lx};
  const uint8_t* planes[4] = {ex, ex, ez, ez};
  for (int k = 0; k < 4; ++k)
    if (counter_gf2::any_parity_row(checks[k], planes[k], lanes, lane, row, rows))
      s_flags[lane][k] = 1;
  int wx = 0, wz = 0;
  for (int j = row; j < n; j += rows) {
    wx += ex[j * lanes + lane];
    wz += ez[j * lanes + lane];
  }
  if (wx) atomicAdd(&s_wx[lane], wx);
  if (wz) atomicAdd(&s_wz[lane], wz);
  __syncthreads();

  if (threadIdx.x == 0) {
    int count = 0, mw = n;
    for (int l = 0; l < lanes; ++l) {
      const bool x_log = s_flags[l][1], z_log = s_flags[l][3];
      const bool x_fail = s_flags[l][0] || x_log;
      const bool z_fail = s_flags[l][2] || z_log;
      const bool fail =
          eval_code == 0 ? x_fail : (eval_code == 1 ? z_fail : x_fail || z_fail);
      count += fail;
      if (x_log) mw = min(mw, s_wx[l]);
      if (z_log) mw = min(mw, s_wz[l]);
    }
    part[2 * blockIdx.x] = count;
    part[2 * blockIdx.x + 1] = mw;
  }
}

}  // namespace

extern "C" int fused_decode_launch(
    uint32_t k0, uint32_t k1, uint32_t cz, uint32_t czx, uint32_t czxy,
    const int32_t* z_chk_nbr, const uint8_t* z_chk_mask,
    const int32_t* z_var_nbr, const int32_t* z_var_slot,
    const uint8_t* z_var_mask, int mx, int rwz, int cwz,
    const int32_t* x_chk_nbr, const uint8_t* x_chk_mask,
    const int32_t* x_var_nbr, const int32_t* x_var_slot,
    const uint8_t* x_var_mask, int mz, int rwx, int cwx,
    const int32_t* lx_nbr, const uint8_t* lx_mask, int kx, int rlx,
    const int32_t* lz_nbr, const uint8_t* lz_mask, int kz, int rlz,
    const float* llr_z, const float* llr_x, int n, int max_iter_z,
    int max_iter_x, float scale, int eval_code, int B, int lanes,
    int smem_bytes, uint8_t* conv_z, int32_t* iter_z, uint8_t* conv_x,
    int32_t* iter_x, int32_t* part, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || kThreads % lanes != 0 || B % lanes != 0)
    return -1;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const minsum::Graph gz{z_chk_nbr, z_chk_mask, z_var_nbr, z_var_slot,
                         z_var_mask, mx, n, rwz, cwz};
  const minsum::Graph gx{x_chk_nbr, x_chk_mask, x_var_nbr, x_var_slot,
                         x_var_mask, mz, n, rwx, cwx};
  const counter_gf2::Cuts cuts{cz, czx, czxy};
  const dim3 grid(B / lanes);
  fused_decode_kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      k0, k1, cuts, gz, gx, Adjacency{lx_nbr, lx_mask, kx, rlx},
      Adjacency{lz_nbr, lz_mask, kz, rlz}, llr_z, llr_x, max_iter_z,
      max_iter_x, scale, eval_code, lanes, conv_z, iter_z, conv_x, iter_x,
      part);
  return (int)cudaGetLastError();
}
