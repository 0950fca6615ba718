// Scaled min-sum belief propagation over a dense one-hot incidence stack,
// its gathers and scatter-sums as bf16 products on the tensor cores.
//
// Replaces the TPU kernel _head_kernel (v1,
// qldpc_fault_tolerance_tpu/ops/bp_pallas.py:335, wrapped by bp_head_pallas
// at :366; loop body _minsum_plane_loop at :227), which keeps the
// (rw, m, n) bf16 one-hot stack resident in VMEM and moves every message
// between the check and the variable grouping as MXU products with it.
//
// Function (ops/bp_kernel.py minsum_dense_plain), per shot:
//   init   v2c_s = bf16(S_s @ bf16(llr0))
//   check  streaming top-2 over the slots of float(v2c) magnitudes (padded
//          slots 1e30), sign product with the syndrome sign;
//          c_s = +-(scale * min(excl, 1e30)), 0 at padded slots (float32)
//   scat   totals = llr0 + sum_s (S_s^T @ bf16(c_s)), slots in order
//   gather t_s = S_s @ bf16(totals); v2c_s = bf16(t_s - c_s) with c_s in
//          float32; parity from t_s < 0 on real edges
// Hard decision totals < 0; outputs freeze at each shot's first
// convergence.  A gather product has one nonzero per output row, so it is
// exact in any order.  A scatter product can sum up to cw messages per
// variable, and a float32 sum of them is not always exact; the head fixes
// the order (PallasHeadGraph.rank): each slot's product splits by rank into
// products with at most one term per variable, exact on the tensor cores,
// and the ranks add in sequence with float32 adds.
//
// Design: a block owns `lanes` shots (16, two 8-wide tensor-core tiles, or 8
// when a code is large) and keeps in shared memory their bf16 messages over
// (rw, m rounded up to 16) rows, their bf16 totals over n rounded up to 16
// rows, and 12 bytes of check state per check (top-2 magnitudes, argmin and
// signs) from which c_s is recomputed in float32.  One bf16 buffer holds
// v2c, then bf16(c_s) (written in place by the check pass, each check's
// slots owned by one thread), then the next v2c (written by the gather).
// The warps split the output tiles of each product; each tile runs
// mma.sync.m16n8k16 (bf16 x bf16 -> f32) along K with the one-hot operand
// loaded from the stack in device memory (2.6 MB at hgp_34_n625, L2
// resident), skipping k-steps whose one-hot tile is zero in the whole warp
// (their products add exact zeros).  The scatter keeps each tile's totals in
// registers across the slots; the gather keeps each tile's parity bits.
// Shots are independent, so a block leaves its loop once all its shots have
// converged (outputs are frozen either way, with or without early_stop).
// Built with -fmad=false so the float32 steps round like the plain version.
//
// Bound: the same min-sum work as kernel 1 per live shot-iteration; the
// dense products do 4 * rw * m * n bf16 operations per shot-iteration on the
// tensor cores, most of them on zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 16;
constexpr int kMaxRank = 8;
constexpr float kBig = 1e30f;

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint16_t bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float value(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

struct Dense {
  const uint16_t* scat;  // (rw, m, n) bf16 bits
  const float* mask;     // (rw, m)
  const int32_t* rank;   // (rw, m)
  int m, n, rw, m16, n16;
  // S_s[i, v], 0 outside the stack
  __device__ uint16_t at(int s, int i, int v) const {
    return (i < m && v < n) ? scat[((size_t)s * m + i) * n + v] : (uint16_t)0;
  }
};

// Check state of one (check, shot): top-2 magnitudes, argmin and signs.
struct CheckState {
  float* min1;
  float* min2;
  uint32_t* info;  // bits 0-4 argmin, bit 5 sign product, bits 8+ own signs
};

__device__ __forceinline__ float c2v_value(const CheckState& cs, int q, int s,
                                           bool valid, float scale) {
  if (!valid) return 0.f;
  const uint32_t info = cs.info[q];
  const float ex = fminf((int)(info & 31u) == s ? cs.min2[q] : cs.min1[q], kBig);
  const float c = scale * ex;
  const bool neg = (((info >> 5) & 1u) != 0u) != (((info >> (8 + s)) & 1u) != 0u);
  return neg ? -c : c;
}

__global__ void __launch_bounds__(kThreads)
bp_dense_kernel(const uint8_t* __restrict__ synd,   // (m, B)
                const float* __restrict__ llr0,     // (n,)
                Dense g,
                uint8_t* __restrict__ err,          // (n, B)
                float* __restrict__ post,           // (n, B)
                uint8_t* __restrict__ conv,         // (B,)
                int32_t* __restrict__ iters,        // (B,)
                int B, int head_iters, float scale, int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_done[kMaxLanes];
  __shared__ int s_bad[kMaxLanes];
  __shared__ int s_iters[kMaxLanes];
  __shared__ int s_ranks[32];
  const int m = g.m, n = g.n, rw = g.rw, m16 = g.m16, n16 = g.n16;
  const size_t sB = (size_t)B;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31, gq = wl >> 2, tq = wl & 3;
  const int b0 = blockIdx.x * lanes;
  uint16_t* msg = (uint16_t*)smem;                        // [(s*m16+i)*lanes+c]
  uint16_t* totb = msg + (size_t)rw * m16 * lanes;        // [v*lanes+c]
  const CheckState cs{(float*)(totb + (size_t)n16 * lanes),
                      (float*)(totb + (size_t)n16 * lanes) + (size_t)m * lanes,
                      (uint32_t*)((float*)(totb + (size_t)n16 * lanes) +
                                  2 * (size_t)m * lanes)};
  const int tiles_n = lanes / 8;

  if (tid < lanes) {
    s_done[tid] = b0 + tid < B ? 0 : 1;
    s_bad[tid] = 0;
    s_iters[tid] = head_iters;
  }
  if (tid < rw) s_ranks[tid] = 1;
  __syncthreads();
  for (int e = tid; e < rw * m; e += kThreads)
    if (g.mask[e] > 0.f) atomicMax(&s_ranks[e / m], g.rank[e] + 1);
  for (int p = tid; p < rw * m16 * lanes; p += kThreads) msg[p] = 0;
  for (int p = tid; p < n16 * lanes; p += kThreads) {
    const int v = p / lanes, c = p % lanes, b = b0 + c;
    totb[p] = v < n ? bits(llr0[v]) : (uint16_t)0;
    if (v < n && b < B) {
      err[v * sB + b] = 0;
      post[v * sB + b] = llr0[v];
    }
  }
  __syncthreads();

  // gather pass: t_s = S_s @ totb for every slot; v2c_s = bf16(t_s - c_s)
  // and, after init, the parity of each (check, shot)
  auto gather = [&](bool init) {
    for (int tile = warp; tile < (m16 / 16) * tiles_n; tile += kWarps) {
      const int i0 = (tile / tiles_n) * 16, c0 = (tile % tiles_n) * 8;
      unsigned par[4] = {0u, 0u, 0u, 0u};
      for (int s = 0; s < rw; ++s) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < n16; k0 += 16) {
          const int ka = k0 + 2 * tq, kb = ka + 8;
          const uint32_t a[4] = {
              pack(g.at(s, i0 + gq, ka), g.at(s, i0 + gq, ka + 1)),
              pack(g.at(s, i0 + gq + 8, ka), g.at(s, i0 + gq + 8, ka + 1)),
              pack(g.at(s, i0 + gq, kb), g.at(s, i0 + gq, kb + 1)),
              pack(g.at(s, i0 + gq + 8, kb), g.at(s, i0 + gq + 8, kb + 1))};
          if (!__any_sync(0xffffffffu, a[0] | a[1] | a[2] | a[3])) continue;
          const int col = c0 + gq;
          const uint32_t bf[2] = {
              pack(totb[ka * lanes + col], totb[(ka + 1) * lanes + col]),
              pack(totb[kb * lanes + col], totb[(kb + 1) * lanes + col])};
          mma_bf16(t, a, bf);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + gq + (q >= 2 ? 8 : 0), c = c0 + 2 * tq + (q & 1);
          if (i >= m) continue;
          const bool valid = g.mask[s * m + i] > 0.f;
          const float cv =
              init ? 0.f : c2v_value(cs, i * lanes + c, s, valid, scale);
          msg[((size_t)s * m16 + i) * lanes + c] = bits(t[q] - cv);
          if (valid && t[q] < 0.f) par[q] ^= 1u;
        }
      }
      if (init) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + gq + (q >= 2 ? 8 : 0), c = c0 + 2 * tq + (q & 1);
        const int b = b0 + c;
        if (i < m && b < B && (par[q] ^ synd[i * sB + b]) & 1u) s_bad[c] = 1;
      }
    }
  };

  gather(true);
  __syncthreads();

  for (int it = 0; it < head_iters; ++it) {
    int all = 1;
    for (int c = 0; c < lanes; ++c) all &= s_done[c];
    if (all) break;

    // check pass: top-2, signs, state; bf16(c_s) in place of v2c
    for (int p = tid; p < m * lanes; p += kThreads) {
      const int i = p / lanes, c = p % lanes, b = b0 + c;
      bool neg_tot = b < B && synd[i * sB + b];
      float min1 = kBig, min2 = kBig;
      int amin = 0;
      uint32_t negs = 0u;
      for (int s = 0; s < rw; ++s) {
        float mag = kBig;
        if (g.mask[s * m + i] > 0.f) {
          const float v = value(msg[((size_t)s * m16 + i) * lanes + c]);
          mag = fabsf(v);
          if (v < 0.f) {
            negs |= 1u << s;
            neg_tot = !neg_tot;
          }
        }
        if (mag < min1) {
          min2 = min1;
          min1 = mag;
          amin = s;
        } else if (mag < min2) {
          min2 = mag;
        }
      }
      cs.min1[p] = min1;
      cs.min2[p] = min2;
      cs.info[p] = (uint32_t)amin | ((neg_tot ? 1u : 0u) << 5) | (negs << 8);
      for (int s = 0; s < rw; ++s)
        msg[((size_t)s * m16 + i) * lanes + c] =
            bits(c2v_value(cs, p, s, g.mask[s * m + i] > 0.f, scale));
    }
    __syncthreads();

    // scatter pass: totals = llr0 + sum over slots of the rank-ordered sums
    for (int tile = warp; tile < (n16 / 16) * tiles_n; tile += kWarps) {
      const int v0 = (tile / tiles_n) * 16, c0 = (tile % tiles_n) * 8;
      float acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = v0 + gq + (q >= 2 ? 8 : 0);
        acc[q] = v < n ? llr0[v] : 0.f;
      }
      for (int s = 0; s < rw; ++s) {
        const int ranks = s_ranks[s];
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        // ranks in groups of kMaxRank register tiles, each group one walk
        // along K; the ranks add to the slot's sum in ascending order
        for (int rb = 0; rb < ranks; rb += kMaxRank) {
          float prod[kMaxRank][4];
#pragma unroll
          for (int r = 0; r < kMaxRank; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) prod[r][q] = 0.f;
          for (int k0 = 0; k0 < m16; k0 += 16) {
            const int ka = k0 + 2 * tq, kb = ka + 8;
            const uint32_t a[4] = {
                pack(g.at(s, ka, v0 + gq), g.at(s, ka + 1, v0 + gq)),
                pack(g.at(s, ka, v0 + gq + 8), g.at(s, ka + 1, v0 + gq + 8)),
                pack(g.at(s, kb, v0 + gq), g.at(s, kb + 1, v0 + gq)),
                pack(g.at(s, kb, v0 + gq + 8), g.at(s, kb + 1, v0 + gq + 8))};
            if (!__any_sync(0xffffffffu, a[0] | a[1] | a[2] | a[3])) continue;
            const int col = c0 + gq;
            const int ks[4] = {ka, ka + 1, kb, kb + 1};
            uint16_t val[4];
            int rk[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = ks[j];
              val[j] = i < m ? msg[((size_t)s * m16 + i) * lanes + col]
                             : (uint16_t)0;
              rk[j] = i < m ? g.rank[s * m + i] - rb : -1;
            }
#pragma unroll
            for (int r = 0; r < kMaxRank; ++r) {
              if (rb + r >= ranks) break;
              const uint32_t bf[2] = {
                  pack(rk[0] == r ? val[0] : 0, rk[1] == r ? val[1] : 0),
                  pack(rk[2] == r ? val[2] : 0, rk[3] == r ? val[3] : 0)};
              mma_bf16(prod[r], a, bf);
            }
          }
#pragma unroll
          for (int r = 0; r < kMaxRank; ++r) {
            if (rb + r >= ranks) break;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              part[q] = rb + r == 0 ? prod[r][q] : part[q] + prod[r][q];
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = acc[q] + part[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = v0 + gq + (q >= 2 ? 8 : 0), c = c0 + 2 * tq + (q & 1);
        const int b = b0 + c;
        if (v >= n) continue;
        totb[v * lanes + c] = bits(acc[q]);
        if (b < B && !s_done[c]) {
          err[v * sB + b] = acc[q] < 0.f ? 1 : 0;
          post[v * sB + b] = acc[q];
        }
      }
    }
    __syncthreads();

    gather(false);
    __syncthreads();
    if (tid < lanes) {
      if (!s_bad[tid] && !s_done[tid]) {
        s_done[tid] = 1;
        s_iters[tid] = it + 1;
      }
      s_bad[tid] = 0;
    }
    __syncthreads();
  }

  if (tid < lanes && b0 + tid < B) {
    conv[b0 + tid] = s_done[tid] ? 1 : 0;
    iters[b0 + tid] = s_iters[tid];
  }
}

}  // namespace

extern "C" int bp_dense_launch(const uint8_t* synd, const float* llr0,
                               const uint16_t* scat, const float* mask,
                               const int32_t* rank, uint8_t* err, float* post,
                               uint8_t* conv, int32_t* iters, int m, int n,
                               int rw, int B, int head_iters, float scale,
                               int lanes, int smem_bytes, void* stream) {
  if ((lanes != 8 && lanes != 16) || rw < 1 || rw > 24) return -1;
  const cudaError_t e = cudaFuncSetAttribute(
      bp_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const Dense g{scat, mask, rank, m, n, rw, (m + 15) / 16 * 16,
                (n + 15) / 16 * 16};
  const dim3 grid((B + lanes - 1) / lanes);
  bp_dense_kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      synd, llr0, g, err, post, conv, iters, B, head_iters, scale, lanes);
  return (int)cudaGetLastError();
}
