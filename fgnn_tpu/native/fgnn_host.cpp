// Native host runtime for fgnn_tpu.
//
// Analog of the reference's OpenMP host paths:
//   * cpu_extraction.cc  — parallel feature gather from the (mmap) feature
//     matrix into a pinned staging buffer (DoCPUFeatureExtract hot path)
//   * pre_sampler.cc     — per-node access frequency counting
//   * cpu_hashtable2.cc  — (host fallback) dedup via sort
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Parallel row gather: out[i] = table[ids[i]] (ids<0 -> zero row).
// Matches cpu_extraction.cc semantics with -1 padding.
void fgnn_gather_f32(const float* table, int64_t num_rows, int64_t dim,
                     const int32_t* ids, int64_t n, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int32_t id = ids[i];
    float* dst = out + i * dim;
    if (id < 0 || id >= num_rows) {
      std::memset(dst, 0, sizeof(float) * dim);
    } else {
      std::memcpy(dst, table + static_cast<int64_t>(id) * dim,
                  sizeof(float) * dim);
    }
  }
}

// Gather only the first n_real rows, zero the padded tail (cache miss
// extraction, ExtractMissData analog).
void fgnn_gather_f32_partial(const float* table, int64_t num_rows,
                             int64_t dim, const int32_t* ids, int64_t n,
                             int64_t n_real, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float* dst = out + i * dim;
    if (i >= n_real) {
      std::memset(dst, 0, sizeof(float) * dim);
      continue;
    }
    int32_t id = ids[i];
    if (id < 0 || id >= num_rows) {
      std::memset(dst, 0, sizeof(float) * dim);
    } else {
      std::memcpy(dst, table + static_cast<int64_t>(id) * dim,
                  sizeof(float) * dim);
    }
  }
}

// Per-node access frequency accumulation (pre_sampler.cc:78-89 analog).
// counts must have num_nodes entries; ids<0 are skipped.
void fgnn_count_freq(const int32_t* ids, int64_t n, int64_t num_nodes,
                     int64_t* counts) {
#if defined(_OPENMP)
  int nt = omp_get_max_threads();
#else
  int nt = 1;
#endif
  if (n < (1 << 16) || nt == 1) {
    for (int64_t i = 0; i < n; ++i) {
      int32_t id = ids[i];
      if (id >= 0 && id < num_nodes) counts[id]++;
    }
    return;
  }
#pragma omp parallel
  {
    std::vector<int64_t> local(num_nodes, 0);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      int32_t id = ids[i];
      if (id >= 0 && id < num_nodes) local[id]++;
    }
#pragma omp critical
    {
      for (int64_t v = 0; v < num_nodes; ++v) counts[v] += local[v];
    }
  }
}

// Argsort descending by count (ranking builder; gnu_parallel::sort analog,
// pre_sampler.cc:96-109). Stable: ties broken by node id ascending.
void fgnn_rank_desc(const int64_t* counts, int64_t num_nodes, int32_t* out) {
  std::vector<int32_t> idx(num_nodes);
  for (int64_t i = 0; i < num_nodes; ++i) idx[i] = static_cast<int32_t>(i);
  std::stable_sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
    return counts[a] > counts[b];
  });
  std::memcpy(out, idx.data(), sizeof(int32_t) * num_nodes);
}

// Host khop sampling (cpu_sampling_khop0.cc analog): uniform without
// replacement via Robert Floyd's algorithm, one thread per seed range.
// seeds<0 produce all -1 slots. RNG: splitmix64 seeded by (seed, i) so
// results are reproducible independent of thread count.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

void fgnn_sample_khop(const int64_t* indptr, const int32_t* indices,
                      const int32_t* inputs, int64_t n_input, int64_t fanout,
                      uint64_t seed, int32_t replace, int32_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_input; ++i) {
    int32_t v = inputs[i];
    int32_t* dst = out + i * fanout;
    if (v < 0) {
      for (int64_t j = 0; j < fanout; ++j) dst[j] = -1;
      continue;
    }
    int64_t off = indptr[v];
    int64_t deg = indptr[v + 1] - off;
    uint64_t st = splitmix64(seed ^ (0x5851f42d4c957f2dull * (uint64_t)i));
    if (deg <= 0) {
      for (int64_t j = 0; j < fanout; ++j) dst[j] = -1;
    } else if (replace) {
      for (int64_t j = 0; j < fanout; ++j) {
        st = splitmix64(st);
        dst[j] = indices[off + (int64_t)(st % (uint64_t)deg)];
      }
    } else if (deg <= fanout) {
      for (int64_t j = 0; j < deg; ++j) dst[j] = indices[off + j];
      for (int64_t j = deg; j < fanout; ++j) dst[j] = -1;
    } else {
      // Floyd's algorithm: fanout distinct picks from [0, deg)
      int64_t picks[256];  // fanout <= 256 enforced by caller
      int64_t np = 0;
      for (int64_t j = 0; j < fanout; ++j) {
        int64_t J = deg - fanout + j;
        st = splitmix64(st);
        int64_t t = (int64_t)(st % (uint64_t)(J + 1));
        bool dup = false;
        for (int64_t k = 0; k < np; ++k)
          if (picks[k] == t) { dup = true; break; }
        picks[np++] = dup ? J : t;
        dst[j] = indices[off + picks[np - 1]];
      }
    }
  }
}

// Weighted host khop (cpu_sampling_weighted_khop.cc analog): inverse-CDF
// draw on the global edge-weight cumsum `gcum` (float64, length num_edge).
// For vertex v with edge range [off, end): draw u in [0, total_v), pick
// the smallest edge slot e with gcum[e] > base + u. With dedup != 0 the
// picks are made UNIQUE per vertex (hash-dedup semantics,
// cpu_sampling_weighted_khop_hash_dedup analog): take-all when
// deg <= fanout, else rejection-sample until fanout distinct slots.
static inline double u01(uint64_t& st) {
  st = splitmix64(st);
  return (double)(st >> 11) * (1.0 / 9007199254740992.0);  // 2^-53
}

void fgnn_sample_weighted_khop(const int64_t* indptr, const int32_t* indices,
                               const double* gcum, const int32_t* inputs,
                               int64_t n_input, int64_t fanout, uint64_t seed,
                               int32_t dedup, int32_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_input; ++i) {
    int32_t v = inputs[i];
    int32_t* dst = out + i * fanout;
    for (int64_t j = 0; j < fanout; ++j) dst[j] = -1;
    if (v < 0) continue;
    int64_t off = indptr[v];
    int64_t end = indptr[v + 1];
    int64_t deg = end - off;
    if (deg <= 0) continue;
    double base = off > 0 ? gcum[off - 1] : 0.0;
    double tot = gcum[end - 1] - base;
    uint64_t st = splitmix64(seed ^ (0x9e3779b97f4a7c15ull * (uint64_t)i));
    if (dedup && deg <= fanout) {  // take-all
      for (int64_t j = 0; j < deg; ++j) dst[j] = indices[off + j];
      continue;
    }
    int64_t picks[256];  // fanout <= 256 enforced by caller
    int64_t np = 0;
    int64_t attempts = 0;
    // bounded retries: under extreme weight concentration dedup rows may
    // come up short (trailing -1 slots) rather than spin — the padded-COO
    // contract treats -1 as absent, matching a clipped reference pick set
    while (np < fanout && attempts < fanout * 64) {
      ++attempts;
      double u = base + u01(st) * tot;
      // lower_bound over gcum[off..end-1] for first value > u
      int64_t lo = off, hi = end;
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (gcum[mid] > u) hi = mid; else lo = mid + 1;
      }
      int64_t e = lo < end ? lo : end - 1;
      if (dedup) {
        bool dup = false;
        for (int64_t k = 0; k < np; ++k)
          if (picks[k] == e) { dup = true; break; }
        if (dup) continue;
      }
      picks[np] = e;
      dst[np++] = indices[e];
    }
  }
}

// CPUHashTable2-style dedup + remap (cpu_hashtable2.cc analog): given the
// current frontier `cur` (padded to S_pad with -1, valid entries keep
// their slot positions) and the flat neighbor picks `nbr`, produce the
// hashtable-invariant unique layout (frontier-first, new nodes ascending)
// and remap every pick to its local position in that layout. The table is
// open-addressing sized O(S_pad + n) — not the O(num_node) dense array of
// the NumPy fallback (444MB/hop at papers100M scale). New nodes beyond
// `cap - S_pad` are dropped (pick remaps to -1), matching the padded-COO
// overflow contract. Returns n_new (new nodes actually appended).
int64_t fgnn_dedup_remap(const int32_t* cur, int64_t S_pad,
                         const int32_t* nbr, int64_t n, int64_t cap,
                         int32_t* unique_out, int32_t* src_local) {
  // table size: next pow2 >= 2*(S_pad + n), min 16
  uint64_t want = 2 * (uint64_t)(S_pad + n);
  uint64_t size = 16;
  while (size < want) size <<= 1;
  const uint64_t hmask = size - 1;
  std::vector<int32_t> keys(size, -1);
  std::vector<int32_t> vals(size, -1);
  auto slot_of = [&](int32_t key) -> uint64_t {
    uint64_t h = splitmix64((uint64_t)(uint32_t)key) & hmask;
    while (keys[h] != -1 && keys[h] != key) h = (h + 1) & hmask;
    return h;
  };

  // 1) frontier keeps its slot positions (holes included)
  for (int64_t i = 0; i < cap; ++i)
    unique_out[i] = i < S_pad ? cur[i] : -1;
  for (int64_t i = 0; i < S_pad; ++i) {
    int32_t v = cur[i];
    if (v < 0) continue;
    uint64_t h = slot_of(v);
    if (keys[h] == -1) { keys[h] = v; vals[h] = (int32_t)i; }
  }

  // 2) collect distinct new nodes (marker -2 = seen, unnumbered)
  std::vector<int32_t> fresh;
  fresh.reserve((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = nbr[i];
    if (v < 0) continue;
    uint64_t h = slot_of(v);
    if (keys[h] == -1) { keys[h] = v; vals[h] = -2; fresh.push_back(v); }
  }

  // 3) ascending order; clip to capacity (dropped stay marker -2 -> -1)
  std::sort(fresh.begin(), fresh.end());
  int64_t n_new = (int64_t)fresh.size();
  if (n_new > cap - S_pad) n_new = cap - S_pad;
  if (n_new < 0) n_new = 0;
  for (int64_t j = 0; j < n_new; ++j) {
    int32_t v = fresh[(size_t)j];
    unique_out[S_pad + j] = v;
    vals[slot_of(v)] = (int32_t)(S_pad + j);
  }

  // 4) remap picks (parallel: table is read-only now)
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = nbr[i];
    if (v < 0) { src_local[i] = -1; continue; }
    int32_t p = vals[slot_of(v)];
    src_local[i] = p >= 0 ? p : -1;
  }
  return n_new;
}

// PinSAGE host sampling (cpu_sampling_random_walk.cc + FrequencyHashmap
// analog): W random walks of length L per seed, each step records the
// visited node then terminates with probability `restart`; per-seed top-K
// visited nodes by multiplicity become the (weighted) neighbors. Walks
// stop at zero-degree nodes. Tie-break: earlier first-visit position wins
// (matches the NumPy golden's stable argsort).
void fgnn_sample_random_walk(const int64_t* indptr, const int32_t* indices,
                             const int32_t* inputs, int64_t n_input,
                             int64_t num_walk, int64_t walk_len,
                             float restart, int64_t topk, uint64_t seed,
                             int32_t* out_nbr, float* out_w) {
  const int64_t M = num_walk * walk_len;
#pragma omp parallel
  {
    std::vector<int32_t> visits(M);
    std::vector<int32_t> cnt(M);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n_input; ++i) {
      int32_t* nbr = out_nbr + i * topk;
      float* w = out_w + i * topk;
      for (int64_t k = 0; k < topk; ++k) { nbr[k] = -1; w[k] = 0.0f; }
      int32_t v = inputs[i];
      if (v < 0) continue;
      uint64_t st = splitmix64(seed ^ (0xda942042e4dd58b5ull * (uint64_t)i));
      for (int64_t wi = 0; wi < num_walk; ++wi) {
        int32_t node = v;
        for (int64_t step = 0; step < walk_len; ++step) {
          int64_t idx = wi * walk_len + step;
          if (node < 0) { visits[idx] = -1; continue; }
          int64_t off = indptr[node];
          int64_t deg = indptr[node + 1] - off;
          if (deg <= 0) { visits[idx] = -1; node = -1; continue; }
          st = splitmix64(st);
          int32_t nxt = indices[off + (int64_t)(st % (uint64_t)deg)];
          visits[idx] = nxt;
          node = (u01(st) < (double)restart) ? -1 : nxt;
        }
      }
      // multiplicity count at first-occurrence positions (others 0)
      for (int64_t a = 0; a < M; ++a) {
        cnt[a] = 0;
        int32_t x = visits[a];
        if (x < 0) continue;
        bool first = true;
        for (int64_t b = 0; b < a; ++b)
          if (visits[b] == x) { first = false; break; }
        if (!first) continue;
        int32_t c = 0;
        for (int64_t b = a; b < M; ++b)
          if (visits[b] == x) ++c;
        cnt[a] = c;
      }
      // top-K by count, stable by position
      for (int64_t k = 0; k < topk; ++k) {
        int64_t best = -1;
        for (int64_t a = 0; a < M; ++a) {
          if (cnt[a] <= 0) continue;
          if (best < 0 || cnt[a] > cnt[best]) best = a;
        }
        if (best < 0) break;
        nbr[k] = visits[best];
        w[k] = (float)cnt[best];
        cnt[best] = 0;
      }
    }
  }
}

}  // extern "C"
