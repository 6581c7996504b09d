// netstats.cpp — native C++ compute core of netrep_tpu_torch's host tier.
//
// The port's own copy of the JAX package's native tier
// (netrep_tpu/native/netstats.cpp), with the same C ABI and the same RNG,
// so the two tiers give the same nulls bit for bit: the seven
// module-preservation statistic kernels (reference: src/netStats.cpp) and
// the threaded permutation procedure (reference:
// src/permutations.cpp::PermutationProcedure over an OpenMP pool,
// BASELINE.json:5). Definitions follow the float64 NumPy oracle
// (netrep_tpu_torch/ops/oracle.py) — oracle and cross-package parity are
// the correctness contract, enforced by tests/test_torch_native.py.
//
// Design (not a translation):
//   * C ABI (extern "C"), loaded from Python via ctypes — no Rcpp-style
//     generated glue, no R types.
//   * std::thread pool with an atomic work counter instead of OpenMP
//     pragmas; permutations own disjoint output slices, so writes are
//     lock-free by construction (same property the reference relies on).
//   * Per-permutation counter-based RNG seeding (splitmix64 of
//     seed ^ global permutation index) so results are independent of the
//     thread count and of how the caller chunks the permutation range —
//     the determinism contract SURVEY.md §4 asks tests to enforce.
//   * Summary profile via power iteration on the standardized data slice
//     (top left singular vector), matching the oracle's SVD + sign-anchor
//     semantics without a LAPACK dependency.
//   * Cooperative cancellation: workers poll a caller-owned flag
//     (the reference's Ctrl-C path, SURVEY.md §5); progress is an atomic
//     counter the caller may read concurrently.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread
// (netrep_tpu_torch/native/build.py, into the kernel-library store).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr int N_STATS = 7;  // STAT_NAMES order, ops/oracle.py:51

// ---------------------------------------------------------------------------
// splitmix64 — seeds one mt19937_64 per (seed, permutation index)
// ---------------------------------------------------------------------------
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// Unbiased bounded draw in [0, bound) via rejection sampling on the raw
// mt19937_64 stream. std::uniform_int_distribution is implementation-
// defined (libstdc++ and libc++ map the same generator stream to different
// values), which would break the advertised determinism contract across
// platforms — this fixed algorithm is part of the RNG spec.
inline uint64_t bounded_draw(std::mt19937_64& gen, uint64_t bound) {
  const uint64_t threshold = (~uint64_t{0} - bound + 1) % bound;  // 2^64 mod bound
  for (;;) {
    const uint64_t r = gen();
    if (r >= threshold) return r % bound;
  }
}

// ---------------------------------------------------------------------------
// statistic building blocks (oracle.py building blocks, SURVEY.md §2.2)
// ---------------------------------------------------------------------------

inline double sgn(double v) { return v > 0 ? 1.0 : (v < 0 ? -1.0 : 0.0); }

// mean off-diagonal edge weight (oracle.avg_edge_weight)
double avg_weight(const double* net, int m) {
  if (m < 2) return NAN;
  double total = 0.0, tr = 0.0;
  for (int i = 0; i < m; ++i) {
    const double* row = net + (size_t)i * m;
    tr += row[i];
    for (int j = 0; j < m; ++j) total += row[j];
  }
  return (total - tr) / ((double)m * (m - 1));
}

// within-module weighted degree: row sums, diagonal excluded
void weighted_degree(const double* net, int m, double* out) {
  for (int i = 0; i < m; ++i) {
    const double* row = net + (size_t)i * m;
    double s = 0.0;
    for (int j = 0; j < m; ++j) s += row[j];
    out[i] = s - row[i];
  }
}

// Pearson correlation of two length-n vectors; NaN when degenerate
double pearson(const double* x, const double* y, int n) {
  if (n < 2) return NAN;
  double mx = 0.0, my = 0.0;
  for (int i = 0; i < n; ++i) { mx += x[i]; my += y[i]; }
  mx /= n; my /= n;
  double sxy = 0.0, sxx = 0.0, syy = 0.0;
  for (int i = 0; i < n; ++i) {
    const double a = x[i] - mx, b = y[i] - my;
    sxy += a * b; sxx += a * a; syy += b * b;
  }
  const double denom = std::sqrt(sxx) * std::sqrt(syy);
  return denom == 0.0 ? NAN : sxy / denom;
}

// Pearson over the off-diagonal entries of two m×m matrices (cor.cor)
double pearson_offdiag(const double* a, const double* b, int m) {
  const long n = (long)m * m - m;
  if (n < 2) return NAN;
  double mx = 0.0, my = 0.0;
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < m; ++j)
      if (i != j) { mx += a[(size_t)i * m + j]; my += b[(size_t)i * m + j]; }
  mx /= n; my /= n;
  double sxy = 0.0, sxx = 0.0, syy = 0.0;
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < m; ++j)
      if (i != j) {
        const double u = a[(size_t)i * m + j] - mx;
        const double v = b[(size_t)i * m + j] - my;
        sxy += u * v; sxx += u * u; syy += v * v;
      }
  const double denom = std::sqrt(sxx) * std::sqrt(syy);
  return denom == 0.0 ? NAN : sxy / denom;
}

// Column-standardize (mean 0, sd 1 with ddof=1; zero-variance columns → 0),
// matching oracle.standardize. z is s×m row-major.
void standardize_cols(double* z, int s, int m) {
  for (int j = 0; j < m; ++j) {
    double mu = 0.0;
    for (int i = 0; i < s; ++i) mu += z[(size_t)i * m + j];
    mu /= s;
    double ss = 0.0;
    for (int i = 0; i < s; ++i) {
      const double d = z[(size_t)i * m + j] - mu;
      ss += d * d;
    }
    const double sd = s > 1 ? std::sqrt(ss / (s - 1)) : 0.0;
    if (sd > 0.0) {
      const double inv = 1.0 / sd;
      for (int i = 0; i < s; ++i)
        z[(size_t)i * m + j] = (z[(size_t)i * m + j] - mu) * inv;
    } else {
      for (int i = 0; i < s; ++i) z[(size_t)i * m + j] = 0.0;
    }
  }
}

// Summary profile (oracle.summary_profile): top left singular vector of the
// standardized s×m slice via power iteration on Z Zᵀ (applied as Z(Zᵀv) so
// no Gram matrix is formed), sign-anchored to the mean node profile.
// prof (s), tmp (m) are caller scratch. z must already be standardized.
void summary_profile(const double* z, int s, int m, double* prof, double* tmp) {
  // anchor = row means of Z — also the power-iteration start (it has a
  // healthy overlap with the top singular direction in practice)
  std::vector<double> anchor(s);
  for (int i = 0; i < s; ++i) {
    double a = 0.0;
    const double* row = z + (size_t)i * m;
    for (int j = 0; j < m; ++j) a += row[j];
    anchor[i] = a / (m > 0 ? m : 1);
  }
  double an = 0.0;
  for (int i = 0; i < s; ++i) an += anchor[i] * anchor[i];
  if (an > 0.0) {
    const double inv = 1.0 / std::sqrt(an);
    for (int i = 0; i < s; ++i) prof[i] = anchor[i] * inv;
  } else {
    // degenerate anchor: deterministic unit start
    for (int i = 0; i < s; ++i) prof[i] = 0.0;
    prof[0] = 1.0;
  }

  std::vector<double> next(s);
  for (int iter = 0; iter < 512; ++iter) {
    // tmp = Zᵀ prof  (m)
    for (int j = 0; j < m; ++j) tmp[j] = 0.0;
    for (int i = 0; i < s; ++i) {
      const double v = prof[i];
      const double* row = z + (size_t)i * m;
      for (int j = 0; j < m; ++j) tmp[j] += row[j] * v;
    }
    // next = Z tmp  (s)
    double nrm = 0.0;
    for (int i = 0; i < s; ++i) {
      const double* row = z + (size_t)i * m;
      double a = 0.0;
      for (int j = 0; j < m; ++j) a += row[j] * tmp[j];
      next[i] = a;
      nrm += a * a;
    }
    nrm = std::sqrt(nrm);
    if (nrm == 0.0) break;  // Z ≡ 0: keep start vector (contribs are 0 anyway)
    double delta = 0.0;
    const double inv = 1.0 / nrm;
    for (int i = 0; i < s; ++i) {
      const double v = next[i] * inv;
      const double d = v - prof[i];
      delta += d * d;
      prof[i] = v;
    }
    if (delta < 1e-26) break;
  }
  // sign anchor (oracle: positive correlation with the mean node profile)
  double dot = 0.0;
  for (int i = 0; i < s; ++i) dot += prof[i] * anchor[i];
  if (dot < 0.0)
    for (int i = 0; i < s; ++i) prof[i] = -prof[i];
}

// Node contribution (oracle.node_contribution): cor(node column, profile)
void node_contribution(const double* z, int s, int m, const double* prof,
                       double* out) {
  double pm = 0.0;
  for (int i = 0; i < s; ++i) pm += prof[i];
  pm /= (s > 0 ? s : 1);
  std::vector<double> pc(s);
  double pn = 0.0;
  for (int i = 0; i < s; ++i) { pc[i] = prof[i] - pm; pn += pc[i] * pc[i]; }
  pn = std::sqrt(pn);
  for (int j = 0; j < m; ++j) {
    double dot = 0.0, xn = 0.0;
    for (int i = 0; i < s; ++i) {
      const double v = z[(size_t)i * m + j];
      dot += v * pc[i];
      xn += v * v;
    }
    const double denom = pn * std::sqrt(xn);
    out[j] = denom == 0.0 ? 0.0 : dot / denom;
  }
}

// ---------------------------------------------------------------------------
// per-module discovery-side fixed properties (oracle.DiscoveryProps)
// ---------------------------------------------------------------------------
struct DiscModule {
  const double* corr;     // m×m discovery correlation submatrix
  const double* degree;   // m
  const double* contrib;  // m, or nullptr when data-less
  int m;
};

struct Scratch {
  std::vector<double> corr, net, z, deg, contrib, prof, tmp;
  std::vector<int> perm;
  void reserve(int max_m, int s, int pool) {
    corr.resize((size_t)max_m * max_m);
    net.resize((size_t)max_m * max_m);
    z.resize((size_t)(s > 0 ? s : 1) * max_m);
    deg.resize(max_m);
    contrib.resize(max_m);
    prof.resize(s > 0 ? s : 1);
    tmp.resize(max_m);
    perm.resize(pool);
  }
};

// The seven statistics for one candidate test-side node set against fixed
// discovery properties (oracle.module_stats). idx holds d.m test indices.
void module_stats(const DiscModule& d, const double* tcorr,
                  const double* tnet, const double* tdata, int n, int s,
                  const int* idx, Scratch& sc, double* out) {
  const int m = d.m;
  // O(m²) gather out of the n×n matrices — the hot access pattern
  // (SURVEY.md §3.1 hot loop)
  for (int i = 0; i < m; ++i) {
    const double* crow = tcorr + (size_t)idx[i] * n;
    const double* nrow = tnet + (size_t)idx[i] * n;
    double* ci = sc.corr.data() + (size_t)i * m;
    double* ni = sc.net.data() + (size_t)i * m;
    for (int j = 0; j < m; ++j) {
      ci[j] = crow[idx[j]];
      ni[j] = nrow[idx[j]];
    }
  }
  for (int k = 0; k < N_STATS; ++k) out[k] = NAN;
  out[0] = avg_weight(sc.net.data(), m);
  out[2] = pearson_offdiag(d.corr, sc.corr.data(), m);
  weighted_degree(sc.net.data(), m, sc.deg.data());
  out[3] = pearson(d.degree, sc.deg.data(), m);

  if (tdata != nullptr && d.contrib != nullptr && s > 0) {
    // gather data columns → z (s×m), standardize, profile, contributions
    for (int i = 0; i < s; ++i) {
      const double* drow = tdata + (size_t)i * n;
      double* zrow = sc.z.data() + (size_t)i * m;
      for (int j = 0; j < m; ++j) zrow[j] = drow[idx[j]];
    }
    standardize_cols(sc.z.data(), s, m);
    summary_profile(sc.z.data(), s, m, sc.prof.data(), sc.tmp.data());
    node_contribution(sc.z.data(), s, m, sc.prof.data(), sc.contrib.data());

    double coh = 0.0, ac = 0.0;
    for (int j = 0; j < m; ++j) {
      coh += sc.contrib[j] * sc.contrib[j];
      ac += sgn(d.contrib[j]) * sc.contrib[j];
    }
    out[1] = m > 0 ? coh / m : NAN;                       // coherence
    out[4] = pearson(d.contrib, sc.contrib.data(), m);    // cor.contrib
    // avg.cor: sign-aware mean over off-diagonal pairs (discovery signs)
    double sum = 0.0;
    const long cnt = (long)m * m - m;
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < m; ++j)
        if (i != j)
          sum += sgn(d.corr[(size_t)i * m + j]) * sc.corr[(size_t)i * m + j];
    out[5] = cnt > 0 ? sum / cnt : NAN;
    out[6] = m > 0 ? ac / m : NAN;                        // avg.contrib
  }
}

std::vector<DiscModule> make_disc(const double* dcorr_cat,
                                  const double* ddeg_cat,
                                  const double* dcontrib_cat,
                                  const int* sizes, int n_mod) {
  std::vector<DiscModule> disc(n_mod);
  size_t coff = 0, voff = 0;
  for (int k = 0; k < n_mod; ++k) {
    const int m = sizes[k];
    disc[k].corr = dcorr_cat + coff;
    disc[k].degree = ddeg_cat + voff;
    disc[k].contrib = dcontrib_cat ? dcontrib_cat + voff : nullptr;
    disc[k].m = m;
    coff += (size_t)m * m;
    voff += m;
  }
  return disc;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// nr_observed — the observed pass (SURVEY.md §3.1 "observed pass"): per
// module, the explicit test-side index set → seven statistics.
//   idx_cat: concatenated test indices (sum of sizes)
//   out:     n_mod × 7, row-major
// ---------------------------------------------------------------------------
void nr_observed(const double* tcorr, const double* tnet, const double* tdata,
                 int n, int s, const int* idx_cat, const int* sizes, int n_mod,
                 const double* dcorr_cat, const double* ddeg_cat,
                 const double* dcontrib_cat, double* out) {
  auto disc = make_disc(dcorr_cat, ddeg_cat, dcontrib_cat, sizes, n_mod);
  int max_m = 1;
  for (int k = 0; k < n_mod; ++k) max_m = std::max(max_m, sizes[k]);
  Scratch sc;
  sc.reserve(max_m, s, 1);
  size_t off = 0;
  for (int k = 0; k < n_mod; ++k) {
    module_stats(disc[k], tcorr, tnet, tdata, n, s, idx_cat + off, sc,
                 out + (size_t)k * N_STATS);
    off += sizes[k];
  }
}

// ---------------------------------------------------------------------------
// nr_null — the permutation procedure (reference PermutationProcedure,
// SURVEY.md §2.2/§3.1): for global permutation indices
// [perm_offset, perm_offset + n_perm), draw one pool permutation, assign
// consecutive chunks to modules (disjoint node sets within a permutation,
// like the reference's label shuffle), and evaluate all seven statistics.
//
//   nulls:    n_perm × n_mod × 7, row-major (caller-allocated)
//   seed:     RNG stream id; permutation p uses splitmix64(seed ^ global p),
//             so results are invariant to n_threads and call chunking.
//   progress: optional counter incremented once per finished permutation
//             (atomic; caller may poll from another thread)
//   cancel:   optional flag; when *cancel != 0 workers stop claiming new
//             permutations (cooperative Ctrl-C, SURVEY.md §5)
// Returns the number of permutations completed (== n_perm unless cancelled;
// when cancelled, completed rows are a PREFIX of the range — workers claim
// indices in order and the return value is the count of finished prefix
// rows).
// ---------------------------------------------------------------------------
long long nr_null(const double* tcorr, const double* tnet,
                  const double* tdata, int n, int s, const int* pool,
                  int pool_size, const int* sizes, int n_mod,
                  const double* dcorr_cat, const double* ddeg_cat,
                  const double* dcontrib_cat, long long n_perm,
                  long long perm_offset, unsigned long long seed,
                  int n_threads, double* nulls, long long* progress,
                  const int* cancel) {
  auto disc = make_disc(dcorr_cat, ddeg_cat, dcontrib_cat, sizes, n_mod);
  int max_m = 1;
  long long total_assigned = 0;
  for (int k = 0; k < n_mod; ++k) {
    max_m = std::max(max_m, sizes[k]);
    total_assigned += sizes[k];
  }
  if (total_assigned > pool_size) return -1;  // caller bug: pool too small

  if (n_threads <= 0)
    n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
  n_threads = (int)std::min<long long>(n_threads, std::max<long long>(1, n_perm));

  std::atomic<long long> next(0);
  std::atomic<long long> done(0);

  auto worker = [&]() {
    Scratch sc;
    sc.reserve(max_m, s, pool_size);
    for (;;) {
      if (cancel && *cancel) break;
      const long long p = next.fetch_add(1, std::memory_order_relaxed);
      if (p >= n_perm) break;
      // counter-based per-permutation RNG (determinism contract above)
      std::mt19937_64 gen(splitmix64(seed ^ (0x5851F42D4C957F2DULL *
                                             (uint64_t)(perm_offset + p + 1))));
      std::memcpy(sc.perm.data(), pool, sizeof(int) * pool_size);
      // partial Fisher–Yates: only the first total_assigned draws are used
      for (long long i = 0; i < total_assigned; ++i) {
        const uint64_t j = (uint64_t)i + bounded_draw(gen, (uint64_t)(pool_size - i));
        std::swap(sc.perm[i], sc.perm[j]);
      }
      size_t off = 0;
      double* row = nulls + (size_t)p * n_mod * N_STATS;
      for (int k = 0; k < n_mod; ++k) {
        module_stats(disc[k], tcorr, tnet, tdata, n, s,
                     sc.perm.data() + off, sc, row + (size_t)k * N_STATS);
        off += sizes[k];
      }
      done.fetch_add(1, std::memory_order_relaxed);
      if (progress)
        __atomic_fetch_add(progress, 1, __ATOMIC_RELAXED);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();

  // Workers poll `cancel` only BEFORE claiming an index and always finish a
  // claimed permutation, so the completed rows are exactly the contiguous
  // prefix [0, done) — no holes.
  return done.load();
}

// ---------------------------------------------------------------------------
// nr_props — the observed network-properties entry (SURVEY.md §2.2
// "Observed network-properties entry"): for one dataset and one module
// index set, return weighted degree, node contribution, summary profile,
// coherence, and average edge weight. Data-less case: pass data=nullptr,
// contrib/profile outputs are left untouched and coherence is NaN.
// ---------------------------------------------------------------------------
void nr_props(const double* corr, const double* net, const double* data,
              int n, int s, const int* idx, int m, double* degree_out,
              double* contrib_out, double* profile_out, double* coherence_out,
              double* avg_weight_out) {
  (void)corr;
  Scratch sc;
  sc.reserve(m, s, 1);
  for (int i = 0; i < m; ++i) {
    const double* nrow = net + (size_t)idx[i] * n;
    double* ni = sc.net.data() + (size_t)i * m;
    for (int j = 0; j < m; ++j) ni[j] = nrow[idx[j]];
  }
  weighted_degree(sc.net.data(), m, degree_out);
  *avg_weight_out = avg_weight(sc.net.data(), m);
  *coherence_out = NAN;
  if (data != nullptr && s > 0) {
    for (int i = 0; i < s; ++i) {
      const double* drow = data + (size_t)i * n;
      double* zrow = sc.z.data() + (size_t)i * m;
      for (int j = 0; j < m; ++j) zrow[j] = drow[idx[j]];
    }
    standardize_cols(sc.z.data(), s, m);
    summary_profile(sc.z.data(), s, m, profile_out, sc.tmp.data());
    node_contribution(sc.z.data(), s, m, profile_out, contrib_out);
    double coh = 0.0;
    for (int j = 0; j < m; ++j) coh += contrib_out[j] * contrib_out[j];
    *coherence_out = m > 0 ? coh / m : NAN;
  }
}

// ABI version stamp so the Python wrapper can detect stale cached builds.
int nr_abi_version() { return 1; }

}  // extern "C"
