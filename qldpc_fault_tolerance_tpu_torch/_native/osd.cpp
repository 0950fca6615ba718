// Ordered-statistics decoding (OSD) over GF(2), host-side.
//
// The host OSD stage of bposd.bposd_decoder (reference
// src/Decoders.py:24-41), a copy of the JAX package's _native/osd.cpp: BP
// runs on the device; the shots whose BP output fails to match the syndrome
// are post-processed here when the device OSD is off (device_osd=False).
//
// Methods (mirroring bposd's osd_method):
//   0 = OSD-0           : solve on the most-error-likely information set
//   1 = OSD-E (order w) : exhaustive 2^w search over the w most suspect
//                         non-pivot columns
//   2 = OSD-CS (order w): "combination sweep" — all weight-1 patterns over
//                         the non-pivot columns plus all weight-2 patterns
//                         within the first w
//
// Candidates are scored by the weighted (log-likelihood) error cost, so the
// winner is the most probable error consistent with the syndrome — this is
// bposd's "osdw" output (osdw_decoding, src/Decoders.py:41).
//
// Representation: the permuted parity-check matrix is bit-packed row-major
// (uint64 words). Gaussian elimination produces U*H_pi in reduced form; each
// candidate solve is then an XOR accumulation over free-column bit vectors.
//
// Threading: shots are independent; a simple atomic work queue fans them out
// across std::thread workers.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using u64 = uint64_t;

struct BitMat {
  int rows = 0, cols = 0, words = 0;
  std::vector<u64> data;  // row-major, words per row
  void init(int r, int c) {
    rows = r;
    cols = c;
    words = (c + 63) / 64;
    data.assign(static_cast<size_t>(r) * words, 0);
  }
  u64* row(int i) { return data.data() + static_cast<size_t>(i) * words; }
  const u64* row(int i) const {
    return data.data() + static_cast<size_t>(i) * words;
  }
  void set(int i, int j) { row(i)[j >> 6] |= (u64(1) << (j & 63)); }
  bool get(int i, int j) const {
    return (row(i)[j >> 6] >> (j & 63)) & 1;
  }
  void xor_rows(int dst, int src) {
    u64* d = row(dst);
    const u64* s = row(src);
    for (int w = 0; w < words; ++w) d[w] ^= s[w];
  }
};

// One decode workspace, reused across shots by a worker thread.
struct OsdWorker {
  int m, n;
  const uint8_t* H;            // m*n row-major {0,1}
  const double* channel_cost;  // n: signed log((1-p)/p) cost of flipping bit j
                               // (negative when a prior exceeds 1/2)

  std::vector<int> order;      // column permutation (most suspect first)
  std::vector<int> pivot_cols; // permuted indices chosen as pivots (size r)
  std::vector<int> free_cols;  // permuted indices not chosen (size n-r)
  BitMat R;                    // m x n reduced permuted matrix
  std::vector<uint8_t> u;      // reduced syndrome (m)
  std::vector<uint8_t> e_perm; // candidate error in permuted coords (n)

  void sort_columns(const double* llr) {
    order.resize(n);
    for (int j = 0; j < n; ++j) order[j] = j;
    // most likely in error first = smallest posterior LLR first
    std::stable_sort(order.begin(), order.end(),
                     [&](int a, int b) { return llr[a] < llr[b]; });
  }

  // Gaussian elimination over the permuted columns; returns rank.
  int eliminate(const uint8_t* synd) {
    R.init(m, n);
    for (int i = 0; i < m; ++i)
      for (int jj = 0; jj < n; ++jj)
        if (H[static_cast<size_t>(i) * n + order[jj]]) R.set(i, jj);
    u.assign(synd, synd + m);

    pivot_cols.clear();
    free_cols.clear();
    std::vector<char> is_pivot(n, 0);
    int r = 0;
    for (int col = 0; col < n && r < m; ++col) {
      int piv = -1;
      for (int i = r; i < m; ++i)
        if (R.get(i, col)) {
          piv = i;
          break;
        }
      if (piv < 0) continue;
      if (piv != r) {
        for (int w = 0; w < R.words; ++w) std::swap(R.row(r)[w], R.row(piv)[w]);
        std::swap(u[r], u[piv]);
      }
      for (int i = 0; i < m; ++i) {
        if (i != r && R.get(i, col)) {
          R.xor_rows(i, r);
          u[i] ^= u[r];
        }
      }
      pivot_cols.push_back(col);
      is_pivot[col] = 1;
      ++r;
    }
    for (int col = 0; col < n; ++col)
      if (!is_pivot[col]) free_cols.push_back(col);
    return r;
  }

  double solution_cost(const std::vector<uint8_t>& e_s,
                       const std::vector<int>& t_bits) const {
    double c = 0.0;
    int r = static_cast<int>(pivot_cols.size());
    for (int i = 0; i < r; ++i)
      if (e_s[i]) c += channel_cost[order[pivot_cols[i]]];
    for (int fj : t_bits) c += channel_cost[order[free_cols[fj]]];
    return c;
  }

  // e_s[i] = u[i] xor sum_{fj in t_bits} R[i][free_cols[fj]] for pivot rows.
  void solve_pivots(const std::vector<int>& t_bits,
                    std::vector<uint8_t>& e_s) const {
    int r = static_cast<int>(pivot_cols.size());
    e_s.assign(r, 0);
    for (int i = 0; i < r; ++i) e_s[i] = u[i];
    for (int fj : t_bits) {
      int col = free_cols[fj];
      for (int i = 0; i < r; ++i) e_s[i] ^= R.get(i, col);
    }
  }

  void emit(const std::vector<uint8_t>& e_s, const std::vector<int>& t_bits,
            uint8_t* out) {
    std::memset(out, 0, n);
    int r = static_cast<int>(pivot_cols.size());
    for (int i = 0; i < r; ++i)
      if (e_s[i]) out[order[pivot_cols[i]]] = 1;
    for (int fj : t_bits) out[order[free_cols[fj]]] = 1;
  }

  void decode(const uint8_t* synd, const double* llr, int method, int osd_order,
              uint8_t* out) {
    sort_columns(llr);
    eliminate(synd);
    int r = static_cast<int>(pivot_cols.size());
    int nfree = static_cast<int>(free_cols.size());

    std::vector<uint8_t> best_es, cand_es;
    std::vector<int> best_t, cand_t;
    solve_pivots({}, best_es);
    double best_cost = solution_cost(best_es, {});

    auto consider = [&](const std::vector<int>& t_bits) {
      solve_pivots(t_bits, cand_es);
      double c = solution_cost(cand_es, t_bits);
      if (c < best_cost) {
        best_cost = c;
        best_es = cand_es;
        best_t = t_bits;
      }
    };

    if (method == 1) {  // OSD-E: all 2^w patterns on first w free cols
      int w = std::min(osd_order, nfree);
      if (w > 20) w = 20;  // safety bound: 2^20 candidates
      for (long pat = 1; pat < (1L << w); ++pat) {
        cand_t.clear();
        for (int b = 0; b < w; ++b)
          if ((pat >> b) & 1) cand_t.push_back(b);
        consider(cand_t);
      }
    } else if (method == 2) {  // OSD-CS: weight-1 sweep + weight-2 in first w
      for (int b = 0; b < nfree; ++b) consider({b});
      int w = std::min(osd_order, nfree);
      for (int a = 0; a < w; ++a)
        for (int b = a + 1; b < w; ++b) consider({a, b});
    }
    (void)r;
    emit(best_es, best_t, out);
  }
};

}  // namespace

extern "C" {

// Batched OSD decode. Returns 0 on success.
//   H            : m*n row-major {0,1}
//   syndromes    : batch*m
//   posterior_llr: batch*n (soft BP output; ordering key)
//   channel_cost : n (signed log((1-p)/p); candidate scoring)
//   method       : 0 osd0, 1 osd_e, 2 osd_cs
//   out          : batch*n error estimates
int qldpc_osd_decode_batch(const uint8_t* H, int m, int n,
                           const uint8_t* syndromes, const double* posterior_llr,
                           int batch, const double* channel_cost, int method,
                           int osd_order, int nthreads, uint8_t* out) {
  if (m <= 0 || n <= 0 || batch < 0) return 1;
  if (batch == 0) return 0;
  if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
  nthreads = std::max(1, std::min(nthreads, batch));

  std::atomic<int> next(0);
  auto work = [&]() {
    OsdWorker w;
    w.m = m;
    w.n = n;
    w.H = H;
    w.channel_cost = channel_cost;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= batch) break;
      w.decode(syndromes + static_cast<size_t>(i) * m,
               posterior_llr + static_cast<size_t>(i) * n, method, osd_order,
               out + static_cast<size_t>(i) * n);
    }
  };

  if (nthreads == 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return 0;
}

// GF(2) rank of an m x n {0,1} matrix (utility for the codes layer).
int qldpc_gf2_rank(const uint8_t* H, int m, int n) {
  BitMat M;
  M.init(m, n);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j)
      if (H[static_cast<size_t>(i) * n + j]) M.set(i, j);
  int r = 0;
  for (int col = 0; col < n && r < m; ++col) {
    int piv = -1;
    for (int i = r; i < m; ++i)
      if (M.get(i, col)) {
        piv = i;
        break;
      }
    if (piv < 0) continue;
    if (piv != r)
      for (int w = 0; w < M.words; ++w) std::swap(M.row(r)[w], M.row(piv)[w]);
    for (int i = r + 1; i < m; ++i)
      if (M.get(i, col)) M.xor_rows(i, r);
    ++r;
  }
  return r;
}

}  // extern "C"
