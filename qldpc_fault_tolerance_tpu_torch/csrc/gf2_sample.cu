// Counter-PRNG depolarizing sample and both syndromes, packed 32 shots per
// word.
//
// Replaces the TPU kernel _sample_syndrome_kernel
// (qldpc_fault_tolerance_tpu/ops/gf2_pallas.py:242), which draws a VMEM
// block of errors and takes both syndromes as dense f32 MXU products mod 2
// (Mosaic had no gather).  Here the syndromes are XOR gathers of packed
// words through the checks' adjacency.
//
// Function: ops/gf2_kernel.py sample_syndrome.  For shot s < B and qubit v
// the draw is Threefry(key, (s, v)).x0; the cuts make it an X, Z or Y error
// (counter_gf2.cuh).  The key's two words are read from device memory, so
// that a captured CUDA graph draws each batch from the key it folds on the
// device.  Shot 32 w + j is bit j of word w.  Outputs, int32 bit
// patterns: the error words ex_p, ez_p (W, n) when emit_errors, and the
// syndrome words sx_p = hz . ex (W, mz), sz_p = hx . ez (W, mx).  Lanes at
// shot >= B (the ragged last word) give zero bits, as pack_shots pads, so
// any B >= 1 is taken.
//
// Design: one block per 32-shot word, 16 warps.  Warp k draws qubits
// v = k, k + 16, ... with one lane per shot and packs each qubit's bits with
// __ballot_sync into the word's error words in shared memory (2 n words,
// 5 KB at n = 625).  After one barrier the block's threads split the checks
// (and, with emit_errors, the qubits) and write the words out, coalesced.
//
// Bound: integer operations.  Each draw is ~80 32-bit operations (20
// rounds of add, rotate, xor and 5 key injections) plus the cut; the I/O is
// 4 bytes per packed word written.  At B = 4096, n = 625 that is 2.56 M
// draws against < 1 MB of output.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_gf2.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gf2_sample_kernel(const uint32_t* __restrict__ key, counter_gf2::Cuts cuts,
                  const int32_t* __restrict__ hx_nbr,   // (mx, rwx)
                  const uint8_t* __restrict__ hx_mask,
                  const int32_t* __restrict__ hz_nbr,   // (mz, rwz)
                  const uint8_t* __restrict__ hz_mask,
                  uint32_t* __restrict__ ex_p,          // (W, n)
                  uint32_t* __restrict__ ez_p,          // (W, n)
                  uint32_t* __restrict__ sx_p,          // (W, mz)
                  uint32_t* __restrict__ sz_p,          // (W, mx)
                  int emit_errors, int n, int mx, int rwx, int mz, int rwz,
                  int B) {
  extern __shared__ uint32_t words[];
  const uint32_t k0 = counter_gf2::key_word(key, 0);
  const uint32_t k1 = counter_gf2::key_word(key, 1);
  uint32_t* exw = words;      // [v]: bit j = shot 32 w + j has an X or Y
  uint32_t* ezw = words + n;  // [v]: ... a Z or Y
  const int w = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int shot = w * 32 + lane;
  const bool valid = shot < B;

  for (int v = warp; v < n; v += kWarps) {
    bool ex = false, ez = false;
    if (valid) {
      counter_gf2::depolarize(counter_gf2::draw(k0, k1, (uint32_t)shot, (uint32_t)v),
                              cuts, ex, ez);
    }
    const uint32_t bx = __ballot_sync(0xffffffffu, ex);
    const uint32_t bz = __ballot_sync(0xffffffffu, ez);
    if (lane == 0) {
      exw[v] = bx;
      ezw[v] = bz;
    }
  }
  __syncthreads();

  const size_t row = (size_t)w;
  if (emit_errors) {
    for (int v = threadIdx.x; v < n; v += kThreads) {
      ex_p[row * n + v] = exw[v];
      ez_p[row * n + v] = ezw[v];
    }
  }
  for (int i = threadIdx.x; i < mz; i += kThreads)
    sx_p[row * mz + i] = counter_gf2::xor_row(hz_nbr, hz_mask, rwz, i, exw);
  for (int i = threadIdx.x; i < mx; i += kThreads)
    sz_p[row * mx + i] = counter_gf2::xor_row(hx_nbr, hx_mask, rwx, i, ezw);
}

}  // namespace

extern "C" int gf2_sample_launch(const uint32_t* key, uint32_t cz,
                                 uint32_t czx, uint32_t czxy,
                                 const int32_t* hx_nbr, const uint8_t* hx_mask,
                                 const int32_t* hz_nbr, const uint8_t* hz_mask,
                                 uint32_t* ex_p, uint32_t* ez_p,
                                 uint32_t* sx_p, uint32_t* sz_p,
                                 int emit_errors, int n, int mx, int rwx,
                                 int mz, int rwz, int B, void* stream) {
  const int W = (B + 31) / 32;
  const int smem_bytes = 2 * n * (int)sizeof(uint32_t);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf2_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const counter_gf2::Cuts cuts{cz, czx, czxy};
  gf2_sample_kernel<<<W, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      key, cuts, hx_nbr, hx_mask, hz_nbr, hz_mask, ex_p, ez_p, sx_p, sz_p,
      emit_errors, n, mx, rwx, mz, rwz, B);
  return (int)cudaGetLastError();
}
