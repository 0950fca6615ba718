// int8 scaled min-sum belief propagation, one tile of shots per cluster.
//
// Replaces the int8 mode of the TPU kernel _sparse_head_kernel
// (qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740, quantize="int8"; loop
// body _minsum_int8_loop at :571, one-hot MXU products _onehot_matmul_ops at
// :694).  There the batch grid cuts the shots into tiles of block_b; here a
// tile is one thread-block cluster.
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
// Design: a tile of block_b shots is a cluster of block_b / lanes blocks
// (lanes <= 32 shots each, at most 16 blocks: a non-portable cluster size).
// Each block keeps its shots' int8 messages (one buffer: the check pass
// turns v2c into c2v in place and the gather pass c2v into the next v2c, each
// check's edges owned by one thread) and their bf16 totals in shared memory:
// lanes * rw * m bytes (rounded up to 16) + lanes * 2 * n bytes.  The
// float32 messages are never stored: each pass that needs a tile maximum
// runs twice, once for the maximum and once to quantize.  A tile maximum is
// a block reduction (warp shuffles); after a cluster barrier every block
// reads the others' partial maxima through distributed shared memory.  The
// maxima are order-free, so every block gets the same scale.  The "all
// converged" flag of early_stop rides with the second maximum.  Two cluster
// barriers per iteration; one launch for the whole batch, no host
// synchronisation inside.  Built with -fmad=false; the two fused
// multiply-adds are explicit (__fmaf_rn), as XLA's CPU backend contracts the
// JAX package's expressions.
//
// Bound: latency of the passes between barriers; per shot-iteration the
// messages cost a few bytes of shared-memory traffic per edge, and the
// posterior and hard decision of a live shot 5 bytes of device memory per
// variable.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 32;
constexpr int kMaxCluster = 16;
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

// Shared state of the cluster-wide reductions.
struct Reduce {
  float* warp;     // [kWarps] per-warp maxima
  float* cta;      // [2] this block's partial maxima, one slot per direction
  int* cta_done;   // [2] this block's "all converged"
  float* out;      // the tile maximum
  int* out_done;   // the tile's "all converged"
};

// The tile maximum of every thread's `v` (>= 0) and, with it, whether every
// block of the tile reports `done`; every thread of the cluster must call it.
// Slot k alternates between the two reductions of an iteration, so a block
// never overwrites a partial that another block may still read.
__device__ float tile_max(float v, int done, int k, Reduce r,
                          cg::cluster_group& cluster, int* all_done) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) r.warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mx = 0.f;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, r.warp[w]);
    r.cta[k] = mx;
    r.cta_done[k] = done;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    float mx = 0.f;
    int all = 1;
    for (unsigned b = 0; b < cluster.num_blocks(); ++b) {
      mx = fmaxf(mx, *cluster.map_shared_rank(&r.cta[k], b));
      all &= *cluster.map_shared_rank(&r.cta_done[k], b);
    }
    *r.out = mx;
    *r.out_done = all;
  }
  __syncthreads();
  if (all_done) *all_done = *r.out_done;
  return *r.out;
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
  __shared__ float s_warp[kWarps];
  __shared__ float s_cta[2];
  __shared__ int s_cta_done[2];
  __shared__ float s_out;
  __shared__ int s_out_done;
  __shared__ int s_done[kMaxLanes];
  __shared__ int s_bad[kMaxLanes];
  __shared__ int s_iters[kMaxLanes];
  cg::cluster_group cluster = cg::this_cluster();
  const Reduce red{s_warp, s_cta, s_cta_done, &s_out, &s_out_done};

  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = kThreads / lanes;
  const int b = blockIdx.x * lanes + lane;
  const size_t sB = (size_t)B;
  int8_t* msg = (int8_t*)smem;  // [e * lanes + lane]
  __nv_bfloat16* totb =         // [j * lanes + lane]
      (__nv_bfloat16*)(smem + (((size_t)rw * m * lanes + 15) & ~(size_t)15));

  if (row == 0) {
    s_done[lane] = 0;
    s_bad[lane] = 0;
    s_iters[lane] = head_iters;
  }
  for (int j = row; j < n; j += rows) {
    err[j * sB + b] = 0;
    post[j * sB + b] = llr0[j];
  }

  // init: bf16 channel LLRs gathered onto the edges, quantized at their own
  // tile maximum
  float local = 0.f;
  for (int i = row; i < m; i += rows)
    for (int s = 0; s < rw; ++s) {
      const int e = s * m + i;
      if (mask[e] > 0.f) local = fmaxf(local, fabsf(bf16_round(llr0[chk_idx[e]])));
    }
  float qv = tile_scale(tile_max(local, 0, 1, red, cluster, nullptr));
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
      const Check c = check_update(msg, mask, i, m, rw, lanes, lane, synd[i * sB + b]);
      for (int s = 0; s < rw; ++s)
        local = fmaxf(local, fabsf(c2v_value(c, s, mask[s * m + i] > 0.f, qv, scale)));
    }
    const float qc = tile_scale(tile_max(local, 0, 0, red, cluster, nullptr));
    for (int i = row; i < m; i += rows) {
      const Check c = check_update(msg, mask, i, m, rw, lanes, lane, synd[i * sB + b]);
      for (int s = 0; s < rw; ++s) {
        const int e = s * m + i;
        msg[e * lanes + lane] = quantize(c2v_value(c, s, mask[e] > 0.f, qv, scale), qc);
      }
    }
    __syncthreads();

    // variable pass: exact integer sum of the int8 c2v, then the totals
    const bool live = !s_done[lane];
    for (int j = row; j < n; j += rows) {
      int acc = 0;
      for (int t = 0; t < cw; ++t) {
        const int e = var_edge[j * cw + t];
        if (e >= 0) acc += msg[e * lanes + lane];
      }
      const float total = __fmaf_rn(qc, (float)acc, llr0[j]);
      totb[j * lanes + lane] = __float2bfloat16_rn(total);
      if (live) {
        err[j * sB + b] = total < 0.f ? 1 : 0;
        post[j * sB + b] = total;
      }
    }
    __syncthreads();

    // gather pass: parity and the v2c tile maximum
    local = 0.f;
    for (int i = row; i < m; i += rows) {
      unsigned par = synd[i * sB + b];
      for (int s = 0; s < rw; ++s) {
        const int e = s * m + i;
        if (mask[e] > 0.f) {
          const float te = __bfloat162float(totb[chk_idx[e] * lanes + lane]);
          const float v = __fmaf_rn(-qc, (float)msg[e * lanes + lane], te);
          local = fmaxf(local, fabsf(v));
          if (te < 0.f) par ^= 1u;
        }
      }
      if (par & 1u) s_bad[lane] = 1;
    }
    __syncthreads();
    if (row == 0) {
      if (!s_bad[lane] && !s_done[lane]) {
        s_done[lane] = 1;
        s_iters[lane] = it + 1;
      }
      s_bad[lane] = 0;
    }
    __syncthreads();
    int cta_done = 1;
    for (int l = 0; l < lanes; ++l) cta_done &= s_done[l];
    int all_done = 0;
    qv = tile_scale(tile_max(local, cta_done, 1, red, cluster, &all_done));

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

  if (row == 0) {
    conv[b] = s_done[lane] ? 1 : 0;
    iters[b] = s_iters[lane];
  }
  // no block may leave while another can still read its partial maxima
  cluster.sync();
}

}  // namespace

extern "C" int bp_int8_launch(const uint8_t* synd, const float* llr0,
                              const int32_t* chk_idx, const float* mask,
                              const int32_t* var_edge, uint8_t* err,
                              float* post, uint8_t* conv, int32_t* iters,
                              int m, int n, int rw, int cw, int B,
                              int head_iters, float scale, int early_stop,
                              int lanes, int cluster, int smem_bytes,
                              void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || kThreads % lanes != 0) return -1;
  if (cluster < 1 || cluster > kMaxCluster || rw > 32) return -1;
  if (B % (lanes * cluster) != 0) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      bp_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(bp_int8_kernel,
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
  e = cudaOccupancyMaxActiveClusters(&active, (void*)bp_int8_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return -2;  // no SM group can hold one cluster
  e = cudaLaunchKernelEx(&cfg, bp_int8_kernel, synd, llr0, chk_idx, mask,
                         var_edge, err, post, conv, iters, m, n, rw, cw, B,
                         head_iters, scale, early_stop, lanes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
