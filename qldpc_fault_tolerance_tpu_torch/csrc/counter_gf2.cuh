// Device pieces shared by the fused code-capacity kernels (gf2_sample.cu,
// gf2_residual.cu, fused_decode.cu): the Threefry-2x32 counter generator,
// the depolarizing cut of one draw, and the XOR-gather parities of checks
// over packed shot words or over one shot's bytes.
//
// The generator is the JAX package's threefry2x32
// (qldpc_fault_tolerance_tpu/ops/gf2_pallas.py:84, the block cipher of
// jax.random's default generator): 20 rounds, key schedule (k0, k1,
// k0 ^ k1 ^ 0x1BD11BDA), injections every 4 rounds.  The draw of shot s and
// qubit v is word x0 of the cipher at counter (s, v), s counted across the
// whole batch, exactly as ops/gf2_kernel.py counter_draws does on the host.
#pragma once

#include <stdint.h>

namespace counter_gf2 {

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// Word i of a key in device memory, loaded where it is used: the load is
// volatile, so the compiler cannot hoist it to the kernel's start and keep
// the word in a register through the decode loops (the words were launch
// arguments, read from the constant bank, before a captured CUDA graph
// needed them in device memory).
__device__ __forceinline__ uint32_t key_word(const uint32_t* key, int i) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(key + i));
  return v;
}

// word x0 of Threefry-2x32 (20 rounds) at key (k0, k1), counter (c0, c1)
__device__ __forceinline__ uint32_t draw(uint32_t k0, uint32_t k1,
                                         uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2;
  return x0;
}

// Depolarizing thresholds [pz, pz+px, pz+px+py] on a 32-bit draw
// (ops/gf2_kernel.py depolarizing_cuts): below cz a Z, then X, then Y.
struct Cuts {
  uint32_t z, zx, zxy;
};

__device__ __forceinline__ void depolarize(uint32_t r, Cuts c, bool& ex,
                                           bool& ez) {
  const bool is_z = r < c.z;
  const bool is_x = r >= c.z && r < c.zx;
  const bool is_y = r >= c.zx && r < c.zxy;
  ex = is_x || is_y;
  ez = is_z || is_y;
}

// XOR of the words of check i's neighbours: one check of 32 packed shots
__device__ __forceinline__ uint32_t xor_row(const int32_t* nbr,
                                            const uint8_t* mask, int rw, int i,
                                            const uint32_t* words) {
  uint32_t acc = 0u;
  for (int s = 0; s < rw; ++s) {
    const int e = i * rw + s;
    if (mask[e]) acc ^= words[nbr[e]];
  }
  return acc;
}

// parity of check i for one shot whose bits sit at [j * lanes + lane]
__device__ __forceinline__ uint8_t parity_row(const int32_t* nbr,
                                              const uint8_t* mask, int rw,
                                              int i, const uint8_t* bits,
                                              int lanes, int lane) {
  uint8_t acc = 0;
  for (int s = 0; s < rw; ++s) {
    const int e = i * rw + s;
    if (mask[e]) acc ^= bits[nbr[e] * lanes + lane];
  }
  return acc;
}

// a padded check adjacency on the device (ops/linalg.py ParityOp)
struct Adjacency {
  const int32_t* nbr;  // (rows, rw)
  const uint8_t* mask;
  int rows, rw;
};

// OR of the parity words of rows start, start + stride, ... of `a`
__device__ __forceinline__ uint32_t any_xor_row(const Adjacency a,
                                                const uint32_t* words,
                                                int start, int stride) {
  uint32_t acc = 0u;
  for (int i = start; i < a.rows; i += stride)
    acc |= xor_row(a.nbr, a.mask, a.rw, i, words);
  return acc;
}

// whether any of rows start, start + stride, ... of `a` has odd parity on
// one shot's bits
__device__ __forceinline__ bool any_parity_row(const Adjacency a,
                                               const uint8_t* bits, int lanes,
                                               int lane, int start,
                                               int stride) {
  bool any = false;
  for (int i = start; i < a.rows; i += stride)
    any |= parity_row(a.nbr, a.mask, a.rw, i, bits, lanes, lane) != 0;
  return any;
}

}  // namespace counter_gf2
