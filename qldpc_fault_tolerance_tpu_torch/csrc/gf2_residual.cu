// Residual stabilizer and logical checks with the errors regenerated from
// their counters, reduced to a failure count and a minimum weight.
//
// Replaces the TPU kernel _residual_check_kernel
// (qldpc_fault_tolerance_tpu/ops/gf2_pallas.py:330), which regenerates a
// VMEM block of errors, unpacks the corrections and takes the four checks as
// dense f32 MXU products.  Here the checks are XOR gathers of packed words.
//
// Function: ops/gf2_kernel.py residual_check_stats.  The error words of
// ops/gf2_kernel.py sample_syndrome (same key, read from device memory, same
// counters) XOR the packed corrections cor_x, cor_z (W, n) into the
// residuals r_x, r_z.  A shot fails X when hz . r_x or lz . r_x is nonzero,
// Z when hx . r_z or lx . r_z is; eval_code 0, 1, 2 counts X, Z or either.  The minimum weight is taken over
// the logical failures of both sectors (|r_x| where lz . r_x != 0, |r_z|
// where lx . r_z != 0), n when there are none: ops/gf2_packed.py
// packed_residual_stats bit for bit.  Lanes at shot >= B count nowhere.
//
// Design: one block per 32-shot word, 16 warps.  The block first copies the
// word's corrections into shared memory (2 n words, coalesced); the warps
// then regenerate the error words as gf2_sample.cu does and XOR them in,
// leaving the residual words there.  The threads then split the checks of
// hz, lz, hx and lx, OR their parity words into four shared flag words, and
// split the qubits for the per-shot weights (lane = shot, summed into shared
// counters).  Warp 0 folds the word into (failures, min weight), written to
// the word's entry of a (W, 2) partial table that the wrapper reduces.
//
// Bound: integer operations, as gf2_sample.cu: one Threefry draw per
// (shot, qubit); the corrections (8 bytes per packed word) are the I/O.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_gf2.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

using counter_gf2::Adjacency;

__global__ void __launch_bounds__(kThreads)
gf2_residual_kernel(const uint32_t* __restrict__ key, counter_gf2::Cuts cuts,
                    const uint32_t* __restrict__ cor_x,  // (W, n)
                    const uint32_t* __restrict__ cor_z,  // (W, n)
                    Adjacency hx, Adjacency hz, Adjacency lx, Adjacency lz,
                    int eval_code, int n, int B,
                    int32_t* __restrict__ part) {  // (W, 2)
  extern __shared__ uint32_t words[];
  const uint32_t k0 = counter_gf2::key_word(key, 0);
  const uint32_t k1 = counter_gf2::key_word(key, 1);
  uint32_t* rx = words;      // residual X words [v]
  uint32_t* rz = words + n;  // residual Z words [v]
  // x_stab, x_log, z_stab, z_log flag words
  __shared__ uint32_t s_flags[4];
  __shared__ int s_wx[32];
  __shared__ int s_wz[32];
  const int w = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int shot = w * 32 + lane;
  const bool valid = shot < B;
  const size_t row = (size_t)w;

  if (threadIdx.x < 4) s_flags[threadIdx.x] = 0u;
  if (threadIdx.x < 32) {
    s_wx[threadIdx.x] = 0;
    s_wz[threadIdx.x] = 0;
  }
  for (int v = threadIdx.x; v < n; v += kThreads) {
    rx[v] = cor_x[row * n + v];
    rz[v] = cor_z[row * n + v];
  }
  __syncthreads();
  for (int v = warp; v < n; v += kWarps) {
    bool ex = false, ez = false;
    if (valid) {
      counter_gf2::depolarize(counter_gf2::draw(k0, k1, (uint32_t)shot, (uint32_t)v),
                              cuts, ex, ez);
    }
    const uint32_t bx = __ballot_sync(0xffffffffu, ex);
    const uint32_t bz = __ballot_sync(0xffffffffu, ez);
    if (lane == 0) {
      rx[v] ^= bx;
      rz[v] ^= bz;
    }
  }
  __syncthreads();

  const int t = threadIdx.x;
  const uint32_t f[4] = {counter_gf2::any_xor_row(hz, rx, t, kThreads),
                         counter_gf2::any_xor_row(lz, rx, t, kThreads),
                         counter_gf2::any_xor_row(hx, rz, t, kThreads),
                         counter_gf2::any_xor_row(lx, rz, t, kThreads)};
  for (int k = 0; k < 4; ++k) {
    const uint32_t red = __reduce_or_sync(0xffffffffu, f[k]);
    if (lane == 0 && red) atomicOr(&s_flags[k], red);
  }
  int wx = 0, wz = 0;
  for (int v = warp; v < n; v += kWarps) {
    wx += (rx[v] >> lane) & 1u;
    wz += (rz[v] >> lane) & 1u;
  }
  atomicAdd(&s_wx[lane], wx);
  atomicAdd(&s_wz[lane], wz);
  __syncthreads();

  if (warp == 0) {
    const uint32_t x_log = s_flags[1], z_log = s_flags[3];
    const uint32_t x_fail = s_flags[0] | x_log;
    const uint32_t z_fail = s_flags[2] | z_log;
    const uint32_t fail =
        eval_code == 0 ? x_fail : (eval_code == 1 ? z_fail : x_fail | z_fail);
    const bool counted = valid && ((fail >> lane) & 1u);
    const int count = __popc(__ballot_sync(0xffffffffu, counted));
    int mw = n;
    if (valid && ((x_log >> lane) & 1u)) mw = min(mw, s_wx[lane]);
    if (valid && ((z_log >> lane) & 1u)) mw = min(mw, s_wz[lane]);
    mw = __reduce_min_sync(0xffffffffu, mw);
    if (lane == 0) {
      part[2 * row] = count;
      part[2 * row + 1] = mw;
    }
  }
}

}  // namespace

extern "C" int gf2_residual_launch(
    const uint32_t* key, uint32_t cz, uint32_t czx, uint32_t czxy,
    const uint32_t* cor_x, const uint32_t* cor_z,
    const int32_t* hx_nbr, const uint8_t* hx_mask, int mx, int rwx,
    const int32_t* hz_nbr, const uint8_t* hz_mask, int mz, int rwz,
    const int32_t* lx_nbr, const uint8_t* lx_mask, int kx, int rlx,
    const int32_t* lz_nbr, const uint8_t* lz_mask, int kz, int rlz,
    int eval_code, int n, int B, int32_t* part, void* stream) {
  const int W = (B + 31) / 32;
  const int smem_bytes = 2 * n * (int)sizeof(uint32_t);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf2_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const counter_gf2::Cuts cuts{cz, czx, czxy};
  gf2_residual_kernel<<<W, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      key, cuts, cor_x, cor_z, Adjacency{hx_nbr, hx_mask, mx, rwx},
      Adjacency{hz_nbr, hz_mask, mz, rwz}, Adjacency{lx_nbr, lx_mask, kx, rlx},
      Adjacency{lz_nbr, lz_mask, kz, rlz}, eval_code, n, B, part);
  return (int)cudaGetLastError();
}
