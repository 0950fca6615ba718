// int8 scaled min-sum belief propagation, one tile of shots per cluster.
//
// Replaces the int8 mode of the TPU kernel _sparse_head_kernel
// (qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740, quantize="int8"; loop
// body _minsum_int8_loop at :571, one-hot MXU products _onehot_matmul_ops at
// :694).  There the batch grid cuts the shots into tiles of block_b; here a
// tile is one thread-block cluster.
//
// Function (ops/bp_kernel.py minsum_int8_plain): the int8 min-sum loop of
// int8_body.cuh (one float32 scale per tile per iteration and direction,
// the check update on raw int8 magnitudes, exact integer scatter-sums, the
// two fused multiply-adds XLA's CPU backend contracts), which this kernel
// shares with the int8 mode of the fused decode (fused_decode_int8.cu).
// Outputs freeze at each shot's first convergence; with early_stop the tile
// leaves its loop when all its shots have converged.
//
// Design: a tile of block_b shots is a cluster of block_b / lanes blocks
// of 1024 threads (lanes <= 32 shots each, at most 16 blocks: a
// non-portable cluster size; a 256-shot tile at hgp_34_n625 is 8 blocks of
// 32 shots).  Each block keeps in shared memory its shots' int8 messages
// (lanes * rw * m, rounded up to 16) and bf16 totals (2 * n * lanes), and,
// where it fits beside them (the wrapper's choice, from the shape), the
// index plane as 16-bit indices (2 * rw * m, rounded up to 16): 111,408 B
// at hgp_34_n625, so two blocks share an SM; the tile maxima go through
// distributed shared memory (int8_body.cuh).  One launch for the whole
// batch, no host synchronisation inside.  The hard decision and posterior
// of a live shot are written to device memory every iteration.
//
// Row weights: a check's real slots and signs are bit masks, 32-bit up to
// row weight 32; the wide instances (kWide, a template flag whose false
// value is the 32-bit code) take 64-bit masks and row weights up to 64
// (int8_body.cuh CheckUpdate), e.g. the circuit space-time detector error
// model's h2 (row weight 40 at hgp_34_n625).  The launcher picks the
// instance from rw.
//
// Bound: latency of the passes between barriers (two cluster barriers per
// iteration); per shot-iteration the messages cost a few bytes of
// shared-memory traffic per edge, and the posterior and hard decision of a
// live shot 5 bytes of device memory per variable.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_body.cuh"

namespace cg = cooperative_groups;

namespace {

using int8body::kMaxLanes;
using int8body::kThreads;
constexpr int kMaxCluster = 16;

__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// B6's inputs and outputs: syndrome of shot b in an (m, B) layout, and the
// live shot's hard decision and posterior written every iteration (they
// must freeze at convergence)
struct DeviceIo {
  const uint8_t* synd_mb;  // (m, B)
  const float* llr0;       // (n,)
  uint8_t* err;            // (n, B)
  float* post;             // (n, B)
  size_t sB;
  int b;
  __device__ uint8_t synd(int i) const { return synd_mb[i * sB + b]; }
  __device__ void init_var(int j) {
    err[j * sB + b] = 0;
    post[j * sB + b] = llr0[j];
  }
  __device__ void store_var(int j, float total, bool live) {
    if (live) {
      err[j * sB + b] = total < 0.f ? 1 : 0;
      post[j * sB + b] = total;
    }
  }
};

template <bool kStaged, bool kWide>
__global__ void __launch_bounds__(kThreads)
bp_int8_kernel(const uint8_t* __restrict__ synd,      // (m, B)
               const float* __restrict__ llr0,        // (n,)
               const int32_t* __restrict__ chk_idx,   // (rw, m)
               const float* __restrict__ mask,        // (rw, m)
               const int32_t* __restrict__ var_edge,  // (n, cw), -1 pads
               uint8_t* __restrict__ err,             // (n, B)
               float* __restrict__ post,              // (n, B)
               uint8_t* __restrict__ conv,            // (B,)
               int32_t* __restrict__ iters,           // (B,)
               int m, int n, int rw, int cw, int B, int head_iters,
               float scale, int early_stop, int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int8body::Shared sh;
  cg::cluster_group cluster = cg::this_cluster();

  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = kThreads / lanes;
  const int b = blockIdx.x * lanes + lane;
  const size_t edges = (size_t)rw * m;
  int16_t* idx = (int16_t*)smem;  // [e], with kStaged
  int8_t* msg =                   // [e * lanes + lane]
      (int8_t*)(smem + (kStaged ? round16(2 * edges) : 0));
  __nv_bfloat16* totb =           // [j * lanes + lane]
      (__nv_bfloat16*)(msg + round16(edges * lanes));

  const int8body::Planes g{chk_idx, mask, var_edge, llr0, m, n, rw, cw};
  DeviceIo io{synd, llr0, err, post, (size_t)B, b};
  int8body::decode<kStaged, kWide>(g, io, int8body::Work{msg, totb, idx}, sh,
                            cluster, lanes, lane, row, rows, head_iters, scale,
                            early_stop != 0);

  if (row == 0) {
    conv[b] = sh.done[lane] ? 1 : 0;
    iters[b] = sh.iters[lane];
  }
  // no block may leave while another can still read its partial maxima
  cluster.sync();
}

}  // namespace

// staged: the index plane goes into shared memory (ops/bp_kernel.py
// int8_staged decides from the shape); smem_bytes must be the layout's
extern "C" int bp_int8_launch(const uint8_t* synd, const float* llr0,
                              const int32_t* chk_idx, const float* mask,
                              const int32_t* var_edge, uint8_t* err,
                              float* post, uint8_t* conv, int32_t* iters,
                              int m, int n, int rw, int cw, int B,
                              int head_iters, float scale, int early_stop,
                              int lanes, int cluster, int staged,
                              int smem_bytes, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || kThreads % lanes != 0) return -1;
  if (cluster < 1 || cluster > kMaxCluster || rw < 1 ||
      rw > int8body::kMaxRowWeight)
    return -1;
  if (B % (lanes * cluster) != 0) return -1;
  const size_t edges = (size_t)rw * m;
  if (staged && n > 32767) return -1;
  if ((size_t)smem_bytes != (staged ? round16(2 * edges) : 0) +
                                round16(edges * lanes) + (size_t)2 * n * lanes)
    return -1;
  // the instance: index plane staged or not, 64-bit slot masks above 32
  const bool wide = rw > 32;
  auto kernel = staged ? (wide ? bp_int8_kernel<true, true>
                               : bp_int8_kernel<true, false>)
                       : (wide ? bp_int8_kernel<false, true>
                               : bp_int8_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B / lanes);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, (void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return -2;  // no SM group can hold one cluster
  e = cudaLaunchKernelEx(&cfg, kernel, synd, llr0, chk_idx, mask, var_edge,
                         err, post, conv, iters, m, n, rw, cw, B, head_iters,
                         scale, early_stop, lanes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
