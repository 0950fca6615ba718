// The whole code-capacity pipeline of a batch in one kernel, int8 messages:
// counter-PRNG sample, both syndromes, both sectors' int8 min-sum decodes,
// residual checks, one thread-block cluster per tile.
//
// Replaces the int8 mode of the TPU kernel _fused_decode_kernel
// (qldpc_fault_tolerance_tpu/ops/gf2_pallas.py:628, quantize="int8"), which
// runs the pipeline on a VMEM tile of block_w * 32 shots with the int8 loop
// _minsum_int8_loop (qldpc_fault_tolerance_tpu/ops/bp_pallas.py:571); the
// tile's shots share each iteration's message scales.  Its bf16 mode is
// fused_decode.cu.
//
// Function: ops/gf2_kernel.py fused_decode_stats (quantize="int8"), plain
// version fused_decode_plain.  For each tile of block_w * 32 consecutive
// shots: the errors of sample_syndrome (Threefry at counters (s, v), the
// key read from device memory), syndromes synd_z = hx . e_z and
// synd_x = hz . e_x, the Z sector's then the X sector's int8 min-sum decode
// with early exit (int8_body.cuh, as
// minsum_int8_plain with block_b = block_w * 32 and early_stop), residuals
// r = e ^ correction and the checks of gf2_residual.cu.  Outputs: each
// shot's converged flag and iterations for both sectors, and per block
// (failures, min weight) in a (blocks, 2) partial table that the wrapper
// reduces.
//
// Design: a block owns 32 shots, one per lane of each of its 32 warps, and a
// tile's block_w blocks form one cluster (8 at hgp_34_n625 with a batch of
// 4096: a portable size), so the tile scales are int8_body.cuh's
// distributed-shared-memory reductions, as in bp_int8.cu.  With a shot per
// lane, a warp's 32 bits of one qubit or check are one 32-bit word (a
// ballot), so everything per shot besides the messages is bit-packed in
// shared memory: both syndromes (a word per check) and both sectors'
// corrections (a word per qubit; the Z sector's waits there while X
// decodes).  The error words are drawn into the message buffer, which the
// decodes have not yet taken, turned into the syndromes and dropped; the
// residual checks draw them again from their counters, as gf2_residual.cu
// does, and XOR them into the corrections in place.  Shared memory per
// block: 32 * rw * m int8 messages (rounded up to 16 bytes) + 64 * n bytes
// of bf16 totals + 4 * (mx + mz) + 8 * n bytes of words (rounded up to 8),
// and, where it fits beside them (the wrapper's choice, from the shape),
// 2 * rw * m of the index plane as 16-bit indices (the larger sector's,
// each restaged for its decode): 118,800 B at hgp_34_n625 (staged),
// 224,616 B at hgp_34_n1225 (not staged).  At 58-60 registers a thread,
// one block of 1024 threads runs per SM, so a batch of 4096 at n625 (16
// tiles of 8 blocks) takes two waves of 15 clusters.
// Nothing but the per-shot flags and the block's two numbers reaches device
// memory.  A cluster barrier separates the two decodes (the second's first
// reduction must not overwrite a partial the first's last may still be
// reading) and ends the kernel.
//
// Row weights up to 32 take 32-bit slot masks; the wide instances (kWide,
// a template flag whose false value is the 32-bit code) 64-bit ones and
// row weights up to 64 in either sector (int8_body.cuh CheckUpdate).
//
// Bound: the decodes' latency — two cluster barriers and four block-wide
// passes per iteration (int8_body.cuh), each tile iterating until its
// slowest shot converges, in each sector.  The kernel draws each (shot, qubit) twice,
// once more than the function needs, rather than keep the errors.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_gf2.cuh"
#include "int8_body.cuh"

namespace cg = cooperative_groups;

namespace {

using counter_gf2::Adjacency;
using int8body::kThreads;
constexpr int kLanes = 32;
constexpr int kRows = kThreads / kLanes;
constexpr int kMaxCluster = 16;

// one sector's decode io: syndrome bits and hard decisions as 32-shot words
struct WordIo {
  const uint32_t* synd_w;  // [i], bit `lane` is the block's shot `lane`
  uint32_t* hard;          // [j]
  int lane;
  __device__ uint8_t synd(int i) const { return (synd_w[i] >> lane) & 1u; }
  __device__ void init_var(int j) {
    if (lane == 0) hard[j] = 0u;
  }
  // a warp holds one variable's 32 shots: live shots take the new decision
  __device__ void store_var(int j, float total, bool live) {
    const uint32_t h = __ballot_sync(0xffffffffu, total < 0.f);
    const uint32_t l = __ballot_sync(0xffffffffu, live);
    if (lane == 0) hard[j] = (hard[j] & ~l) | (h & l);
  }
};

// a warp's 32 shots of qubit j: their X and Z error bits as two words
__device__ __forceinline__ void error_words(uint32_t k0, uint32_t k1,
                                           counter_gf2::Cuts cuts, uint32_t b,
                                           int j, uint32_t& wx, uint32_t& wz) {
  bool bx, bz;
  counter_gf2::depolarize(counter_gf2::draw(k0, k1, b, (uint32_t)j), cuts, bx, bz);
  wx = __ballot_sync(0xffffffffu, bx);
  wz = __ballot_sync(0xffffffffu, bz);
}

__host__ __device__ inline size_t message_bytes(int n, int ez, int ex) {
  const size_t msg = (((size_t)kLanes * (ez > ex ? ez : ex)) + 15) & ~(size_t)15;
  return msg > 8 * (size_t)n ? msg : 8 * (size_t)n;
}

// bytes of the message buffer, the totals and the words, rounded up to 8:
// where the index plane starts
__host__ __device__ inline size_t word_end(int n, int mx, int mz, int ez,
                                           int ex) {
  return (message_bytes(n, ez, ex) + (size_t)64 * n + 4 * (size_t)(mx + mz) +
          8 * (size_t)n + 7) & ~(size_t)7;
}

__host__ __device__ inline size_t smem_bytes_of(int n, int mx, int mz, int ez,
                                                int ex, bool staged) {
  return word_end(n, mx, mz, ez, ex) +
         (staged ? 2 * (size_t)(ez > ex ? ez : ex) : 0);
}

template <bool kStaged, bool kWide>
__global__ void __launch_bounds__(kThreads)
fused_decode_int8_kernel(const uint32_t* __restrict__ key, counter_gf2::Cuts cuts,
                         int8body::Planes gz,  // of hx: decodes synd_z
                         int8body::Planes gx,  // of hz: decodes synd_x
                         Adjacency hx, Adjacency hz, Adjacency lx,
                         Adjacency lz, int max_iter_z, int max_iter_x,
                         float scale, int eval_code,
                         uint8_t* __restrict__ conv_z,
                         int32_t* __restrict__ iter_z,
                         uint8_t* __restrict__ conv_x,
                         int32_t* __restrict__ iter_x,
                         int32_t* __restrict__ part) {  // (blocks, 2)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int8body::Shared sh;
  // x_stab, x_log, z_stab, z_log as 32-shot words, then residual weights
  __shared__ uint32_t s_flags[4];
  __shared__ int s_wx[kLanes];
  __shared__ int s_wz[kLanes];
  cg::cluster_group cluster = cg::this_cluster();

  const int n = gz.n;
  const int lane = threadIdx.x % kLanes;
  const int row = threadIdx.x / kLanes;
  const uint32_t b = blockIdx.x * kLanes + lane;
  int8_t* msg = (int8_t*)smem;  // [e * 32 + lane]
  __nv_bfloat16* totb =         // [j * 32 + lane]
      (__nv_bfloat16*)(smem + message_bytes(n, gz.rw * gz.m, gx.rw * gx.m));
  uint32_t* synd_z = (uint32_t*)(totb + (size_t)n * kLanes);  // [i]
  uint32_t* synd_x = synd_z + hx.rows;
  uint32_t* cor_z = synd_x + hz.rows;  // [j]: Z correction, then r_z
  uint32_t* cor_x = cor_z + n;         // [j]: X correction, then r_x
  uint32_t* ex_w = (uint32_t*)smem;    // the errors, before the decodes
  uint32_t* ez_w = ex_w + n;
  const int ez = gz.rw * gz.m, ex = gx.rw * gx.m;
  int16_t* idx =  // [e], with kStaged
      (int16_t*)(smem + word_end(n, hx.rows, hz.rows, ez, ex));
  const int8body::Work work{msg, totb, idx};

  if (threadIdx.x < 4) s_flags[threadIdx.x] = 0u;
  if (threadIdx.x < kLanes) {
    s_wx[threadIdx.x] = 0;
    s_wz[threadIdx.x] = 0;
  }
  {
    const uint32_t k0 = counter_gf2::key_word(key, 0);
    const uint32_t k1 = counter_gf2::key_word(key, 1);
    for (int j = row; j < n; j += kRows) {
      uint32_t wx, wz;
      error_words(k0, k1, cuts, b, j, wx, wz);
      if (lane == 0) {
        ex_w[j] = wx;
        ez_w[j] = wz;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hx.rows; i += kThreads)
    synd_z[i] = counter_gf2::xor_row(hx.nbr, hx.mask, hx.rw, i, ez_w);
  for (int i = threadIdx.x; i < hz.rows; i += kThreads)
    synd_x[i] = counter_gf2::xor_row(hz.nbr, hz.mask, hz.rw, i, ex_w);
  __syncthreads();

  // the Z sector's decode, then the X sector's, from one call site (one
  // inlined copy of the loop); a cluster barrier separates them: the
  // second's first reduction must not overwrite a partial that the first's
  // last may still be reading
#pragma unroll 1
  for (int sector = 0; sector < 2; ++sector) {
    const bool z = sector == 0;
    if (!z) cluster.sync();
    WordIo io{z ? synd_z : synd_x, z ? cor_z : cor_x, lane};
    int8body::decode<kStaged, kWide>(z ? gz : gx, io, work, sh, cluster, kLanes,
                              lane, row, kRows, z ? max_iter_z : max_iter_x,
                              scale, true);
    if (row == 0) {
      (z ? conv_z : conv_x)[b] = sh.done[lane] ? 1 : 0;
      (z ? iter_z : iter_x)[b] = sh.iters[lane];
    }
  }
  __syncthreads();

  // residuals: the errors drawn again (the key read again, not held
  // through the decodes), XORed into the corrections
  {
    const uint32_t k0 = counter_gf2::key_word(key, 0);
    const uint32_t k1 = counter_gf2::key_word(key, 1);
    for (int j = row; j < n; j += kRows) {
      uint32_t wx, wz;
      error_words(k0, k1, cuts, b, j, wx, wz);
      if (lane == 0) {
        cor_x[j] ^= wx;
        cor_z[j] ^= wz;
      }
    }
  }
  __syncthreads();

  // residual checks: hz and lz on r_x, hx and lx on r_z
  const Adjacency checks[4] = {hz, lz, hx, lx};
  const uint32_t* planes[4] = {cor_x, cor_x, cor_z, cor_z};
  for (int k = 0; k < 4; ++k) {
    const uint32_t any =
        counter_gf2::any_xor_row(checks[k], planes[k], threadIdx.x, kThreads);
    if (any) atomicOr(&s_flags[k], any);
  }
  int wx = 0, wz = 0;
  for (int j = row; j < n; j += kRows) {
    wx += (cor_x[j] >> lane) & 1u;
    wz += (cor_z[j] >> lane) & 1u;
  }
  if (wx) atomicAdd(&s_wx[lane], wx);
  if (wz) atomicAdd(&s_wz[lane], wz);
  __syncthreads();

  if (threadIdx.x == 0) {
    const uint32_t x_log = s_flags[1], z_log = s_flags[3];
    const uint32_t x_fail = s_flags[0] | x_log, z_fail = s_flags[2] | z_log;
    const uint32_t fail =
        eval_code == 0 ? x_fail : (eval_code == 1 ? z_fail : x_fail | z_fail);
    int mw = n;
    for (int l = 0; l < kLanes; ++l) {
      if ((x_log >> l) & 1u) mw = min(mw, s_wx[l]);
      if ((z_log >> l) & 1u) mw = min(mw, s_wz[l]);
    }
    part[2 * blockIdx.x] = __popc(fail);
    part[2 * blockIdx.x + 1] = mw;
  }
  // no block may leave while another can still read its partial maxima
  cluster.sync();
}

// the launch configuration of a batch of B shots in tiles of `cluster`
// blocks; attr must outlive cfg
void configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int B,
               int cluster, int smem_bytes, void* stream) {
  cfg = {};
  cfg.gridDim = dim3(B / kLanes);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// the kernel instance of a layout: index plane staged or not, 64-bit slot
// masks (row weights 33..64) or 32-bit
auto kernel_of(bool staged, bool wide) {
  return staged ? (wide ? fused_decode_int8_kernel<true, true>
                        : fused_decode_int8_kernel<true, false>)
                : (wide ? fused_decode_int8_kernel<false, true>
                        : fused_decode_int8_kernel<false, false>);
}

cudaError_t set_attributes(bool staged, bool wide, int cluster,
                           int smem_bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel_of(staged, wide), cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kernel_of(staged, wide),
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

}  // namespace

// How many tiles of `cluster` blocks can run at once on the card (the
// batch's waves are its tiles over this); negative on an error.
extern "C" int fused_decode_int8_active_clusters(int cluster, int staged,
                                                 int wide, int smem_bytes) {
  if (cluster < 1 || cluster > kMaxCluster) return -1;
  if (set_attributes(staged, wide, cluster, smem_bytes) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(cfg, attr, cluster * kLanes, cluster, smem_bytes, nullptr);
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, (void*)kernel_of(staged, wide),
                                     &cfg) != cudaSuccess)
    return -1;
  return active;
}

// staged: the index plane goes into shared memory (ops/gf2_kernel.py
// fused_int8_staged decides from the shape); smem_bytes must be the layout's
extern "C" int fused_decode_int8_launch(
    const uint32_t* key, uint32_t cz, uint32_t czx, uint32_t czxy,
    const int32_t* z_chk_idx, const float* z_mask, const int32_t* z_var_edge,
    int mx, int rwz, int cwz, const int32_t* x_chk_idx, const float* x_mask,
    const int32_t* x_var_edge, int mz, int rwx, int cwx,
    const int32_t* hx_nbr, const uint8_t* hx_mask, int hx_rows, int hx_rw,
    const int32_t* hz_nbr, const uint8_t* hz_mask, int hz_rows, int hz_rw,
    const int32_t* lx_nbr, const uint8_t* lx_mask, int kx, int rlx,
    const int32_t* lz_nbr, const uint8_t* lz_mask, int kz, int rlz,
    const float* llr_z, const float* llr_x, int n, int max_iter_z,
    int max_iter_x, float scale, int eval_code, int B, int cluster,
    int staged, int smem_bytes, uint8_t* conv_z, int32_t* iter_z,
    uint8_t* conv_x, int32_t* iter_x, int32_t* part, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || rwz < 1 ||
      rwz > int8body::kMaxRowWeight || rwx < 1 ||
      rwx > int8body::kMaxRowWeight)
    return -1;
  if (B % (kLanes * cluster) != 0 || hx_rows != mx || hz_rows != mz) return -1;
  if (staged && n > 32767) return -1;
  if ((size_t)smem_bytes !=
      smem_bytes_of(n, mx, mz, rwz * mx, rwx * mz, staged != 0))
    return -1;
  const bool wide = rwz > 32 || rwx > 32;
  cudaError_t e = set_attributes(staged, wide, cluster, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(cfg, attr, B, cluster, smem_bytes, stream);
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, (void*)kernel_of(staged, wide),
                                     &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return -2;  // no SM group can hold one cluster
  const int8body::Planes gz{z_chk_idx, z_mask, z_var_edge, llr_z, mx, n, rwz, cwz};
  const int8body::Planes gx{x_chk_idx, x_mask, x_var_edge, llr_x, mz, n, rwx, cwx};
  e = cudaLaunchKernelEx(
      &cfg, kernel_of(staged, wide), key, counter_gf2::Cuts{cz, czx, czxy}, gz,
      gx, Adjacency{hx_nbr, hx_mask, hx_rows, hx_rw},
      Adjacency{hz_nbr, hz_mask, hz_rows, hz_rw},
      Adjacency{lx_nbr, lx_mask, kx, rlx}, Adjacency{lz_nbr, lz_mask, kz, rlz},
      max_iter_z, max_iter_x, scale, eval_code, conv_z, iter_z, conv_x, iter_x,
      part);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
