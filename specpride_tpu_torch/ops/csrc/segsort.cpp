// Threaded segmented stable argsort and int32 searchsorted for the host
// packs (C ABI, loaded with ctypes by ops/_build.py::load_host).
//
// The port's copy of the JAX package's native/segsort.cpp, with the same
// entry points, arguments and thread default.  The packs sort peaks by bin
// WITHIN independent segments (clusters for the flat bin-mean, spectra for
// the cosine prep, rows for the medoid); numpy's one global lexsort over
// (segment, key) runs on one core and ignores the segments, while sorting
// each segment alone is cache-friendly and spreads over every core.  Ties
// keep input order, as np.argsort(kind="stable") and np.lexsort do: the
// port's plain versions (ops/segsort.py) give the same permutation.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <numeric>
#include <thread>
#include <vector>

extern "C" {

// order_out receives GLOBAL indices: for each segment s,
// order_out[offsets[s]:offsets[s+1]] is offsets[s] + the stable argsort of
// keys[offsets[s]:offsets[s+1]].  Segments are claimed from an atomic
// counter; n_threads <= 0 means one per hardware thread.
int seg_argsort_i64(
    const int64_t* keys,
    const int64_t* offsets,  // (n_segs + 1,)
    int64_t n_segs,
    int64_t* order_out,
    int n_threads) {
  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc ? static_cast<int>(hc) : 4;
  }
  n_threads = std::min<int64_t>(n_threads, std::max<int64_t>(n_segs, 1));

  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t s = next.fetch_add(1);
      if (s >= n_segs) return;
      const int64_t lo = offsets[s], hi = offsets[s + 1];
      std::iota(order_out + lo, order_out + hi, lo);
      std::stable_sort(order_out + lo, order_out + hi,
                       [&](int64_t a, int64_t b) { return keys[a] < keys[b]; });
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}

// searchsorted (side='right') in blocks of 65,536 queries claimed from an
// atomic counter: out[i] = the number of keys <= queries[i], keys ascending.
int searchsorted_right_i32(
    const int32_t* keys,
    int64_t n_keys,
    const int32_t* queries,
    int64_t n_queries,
    int64_t* out,
    int n_threads) {
  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc ? static_cast<int>(hc) : 4;
  }
  n_threads = std::min<int64_t>(n_threads, std::max<int64_t>(n_queries, 1));
  std::atomic<int64_t> next{0};
  const int64_t block = 1 << 16;
  auto worker = [&]() {
    for (;;) {
      int64_t lo = next.fetch_add(block);
      if (lo >= n_queries) return;
      int64_t hi = std::min(lo + block, n_queries);
      for (int64_t i = lo; i < hi; ++i) {
        out[i] = std::upper_bound(keys, keys + n_keys, queries[i]) - keys;
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}

}  // extern "C"
