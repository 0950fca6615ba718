// Scaled min-sum belief propagation for a batch of syndromes: kernel 1
// (float32 messages) and the bf16 BP head, two instances of one loop.
//
// Replaces the TPU kernel _sparse_head_kernel
// (qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740, loop body
// _minsum_plane_loop at :227) in its bf16 mode, and the dense v1 head
// _head_kernel (:335), which runs the same loop over a resident one-hot
// stack; both use one-hot MXU products standing in for gathers.  Here the
// gathers are plain loads through the graph's index maps.
//
// Function: per-check top-2 minimum and sign product (with the syndrome
// sign), scaled check-to-variable messages, variable totals, v2c = total -
// own c2v, hard decision, parity against the syndrome.  Each shot's outputs
// (error, posterior, iterations) freeze at its first convergence; a
// converged shot does no further work, which is exact because its outputs
// are frozen either way.
//   bp_minsum_launch (kernel 1; ops/bp.py bp_decode(method="minimum_sum"),
//     plain version minsum_plain): float32 messages over the Tanner graph,
//     variable totals summed in list order.
//   bp_minsum_bf16_launch (the bf16 head; ops/bp_kernel.py bp_head_bf16,
//     plain version minsum_dense_plain): bf16 v2c over a head's slot-major
//     index planes, each variable's terms summed slot by slot in ascending
//     check order.  Its shots are independent, so the JAX tile (which only
//     gates whether the head runs) plays no part, and a block's early exit
//     is the tile early exit's result.
//
// Design: a block owns `lanes` shots (8, or fewer when a shot's messages
// would not fit) and keeps their messages in shared memory, edge-major and
// shot-minor (v2c and c2v at [e * lanes + lane]), with the hard decisions the
// parity pass reads.  Thread t works for shot t % lanes on row t / lanes;
// the rows split the checks (check pass, parity pass) and the variables
// (variable pass) between barriers.  The block leaves its iteration loop
// once all its shots have converged, so small batches (the two-phase tail,
// B/16 shots) spread over many SMs and blocks of converged shots stop early.
// Device memory sees the syndromes and channel LLRs read, and the hard
// decisions and posteriors of live shots written once per iteration (they
// must freeze at convergence), in (n, B) / (m, B) batch-minor layouts.  The
// decode loop itself is minsum_body.cuh, shared with fused_decode.cu.
//
// Bound: the iterations are latency-bound chains of shared-memory passes
// between barriers; per live shot-iteration the messages cost 16 B (f32) or
// 12 B (bf16) per edge of shared-memory traffic and the outputs 5 B per
// variable of device memory.  Shared memory per block: lanes * (8 * m * rw
// + n) bytes (f32) or lanes * (6 * m * rw + n) (bf16).
#include <cuda_runtime.h>
#include <stdint.h>

#include "minsum_body.cuh"

namespace {

constexpr int kMaxLanes = minsum::kMaxLanes;
constexpr int kThreads = 1024;

// kernel 1's inputs and outputs: syndromes and LLRs of shot b in (m, B) /
// (n, B) layouts, and the live shot's hard decision and posterior written
// every iteration (they must freeze at convergence)
struct DeviceIo {
  const uint8_t* synd_mb;  // (m, B)
  const float* llr;
  int llr_per_shot;
  uint8_t* err;
  float* post;
  size_t sB;
  int b;
  __device__ uint8_t synd(int i) const { return synd_mb[i * sB + b]; }
  __device__ float llr0(int j) const { return llr_per_shot ? llr[j * sB + b] : llr[j]; }
  __device__ void init_var(int j) {
    err[j * sB + b] = 0;
    post[j * sB + b] = llr0(j);
  }
  __device__ void store_var(int j, uint8_t h, float total) {
    err[j * sB + b] = h;
    post[j * sB + b] = total;
  }
};

template <class Msg, class G>
__global__ void __launch_bounds__(kThreads)
bp_minsum_kernel(const uint8_t* __restrict__ synd,  // (m, B)
                 const float* __restrict__ llr0,    // (n,) or (n, B)
                 int llr_per_shot, const G g,
                 uint8_t* __restrict__ err,         // (n, B)
                 float* __restrict__ llr,           // (n, B)
                 uint8_t* __restrict__ conv,        // (B,)
                 int32_t* __restrict__ iters,       // (B,)
                 int B, int max_iter, float scale, int lanes) {
  extern __shared__ float smem[];
  __shared__ int s_done[kMaxLanes];
  __shared__ int s_bad[kMaxLanes];
  __shared__ int s_iters[kMaxLanes];
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = kThreads / lanes;
  const int b = blockIdx.x * lanes + lane;
  const bool valid = b < B;
  const size_t E = (size_t)g.m * g.rw;
  float* c2v = smem;                                          // [e * lanes + lane]
  auto* v2c = (typename Msg::T*)(c2v + E * lanes);            // [e * lanes + lane]
  uint8_t* hard = (uint8_t*)(v2c + E * lanes);                // [j * lanes + lane]

  DeviceIo io{synd, llr0, llr_per_shot, err, llr, (size_t)B, b};
  minsum::decode<Msg>(g, io, v2c, c2v, hard,
                      minsum::LaneState{s_done, s_bad, s_iters}, lanes, lane,
                      row, rows, valid, max_iter, scale);

  if (row == 0 && valid) {
    conv[b] = s_done[lane] ? 1 : 0;
    iters[b] = s_iters[lane];
  }
}

template <class Msg, class G>
int launch(const uint8_t* synd, const float* llr0, int llr_per_shot,
           const G& g, uint8_t* err, float* llr, uint8_t* conv,
           int32_t* iters, int B, int max_iter, float scale, int lanes,
           int smem_bytes, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || kThreads % lanes != 0) return -1;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bp_minsum_kernel<Msg, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + lanes - 1) / lanes);
  bp_minsum_kernel<Msg, G><<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      synd, llr0, llr_per_shot, g, err, llr, conv, iters, B, max_iter, scale,
      lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bp_minsum_launch(const uint8_t* synd, const float* llr0,
                                int llr_per_shot, const int32_t* chk_nbr,
                                const uint8_t* chk_mask,
                                const int32_t* var_nbr,
                                const int32_t* var_slot,
                                const uint8_t* var_mask, uint8_t* err,
                                float* llr, uint8_t* conv, int32_t* iters,
                                int m, int n, int rw, int cw, int B,
                                int max_iter, float scale, int lanes,
                                int smem_bytes, void* stream) {
  const minsum::Graph g{chk_nbr, chk_mask, var_nbr, var_slot, var_mask,
                        m, n, rw, cw};
  return launch<minsum::F32Msg>(synd, llr0, llr_per_shot, g, err, llr, conv,
                                iters, B, max_iter, scale, lanes, smem_bytes,
                                stream);
}

// the bf16 head: one channel-LLR vector shared by the shots
extern "C" int bp_minsum_bf16_launch(const uint8_t* synd, const float* llr0,
                                     const int32_t* chk_idx, const float* mask,
                                     const int32_t* var_edge, uint8_t* err,
                                     float* llr, uint8_t* conv,
                                     int32_t* iters, int m, int n, int rw,
                                     int cw, int B, int max_iter, float scale,
                                     int lanes, int smem_bytes, void* stream) {
  const minsum::SlotPlanes g{chk_idx, mask, var_edge, m, n, rw, cw, 1.0f / m};
  return launch<minsum::Bf16Msg>(synd, llr0, 0, g, err, llr, conv, iters, B,
                                 max_iter, scale, lanes, smem_bytes, stream);
}
