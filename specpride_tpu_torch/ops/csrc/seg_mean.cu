// Fused segmented mean over runs of equal adjacent keys, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel specpride_tpu/ops/pallas_kernels.py
// seg_mean_pallas (body _seg_mean_block_kernel, core _block_scan_chain).
// Per element i, with runs = maximal spans of equal ADJACENT keys:
//   count[i]  = sum of w over the run from its start through i
//   mean_c[i] = (sum of v_c * w over the same span) / max(count[i], 1)
// so the value at a run's last element is the run's weighted mean.  A
// zero-weight slot inside a run reads the count of the valid slots before
// it; a run masked from its start reads count 0 / mean 0.
//
// Bound: memory.  The function must read key, w and nv values and write
// 1 + nv outputs: 20 B/element for nv = 1, 28 B for nv = 2, against a few
// flops per element.  One launch of seg_scan_core.cuh's single-pass scan
// over the channels (w, v_c * w); the store divides, after the carry has
// reached the tile's leading run, so every input is read once and every
// output written once: the bound's bytes plus a 32-byte record per tile.

#include "seg_scan_core.cuh"

namespace {

// Channels (w, v0 * w[, v1 * w]); a head where the key changes.
template <int NC>
struct MeanLoad {
  const int* keys;
  const float* w;
  const float* v0;
  const float* v1;

  __device__ __forceinline__ unsigned operator()(
      long long i0, long long n, bool vec, float (&x)[NC][kItems],
      uint4* stage) const {
    unsigned key[kItems], u[NC][kItems];
    fetch_words(keys, i0, n, vec, key);
    const unsigned before = key_before(keys, i0, n);
    fetch_words(w, i0, n, vec, u[0]);
    fetch_words(v0, i0, n, vec, u[1]);
    if constexpr (NC == 3) fetch_words(v1, i0, n, vec, u[2]);
#pragma unroll
    for (int c = 0; c < NC; ++c) as_floats(u[c], vec, stage, x[c]);
#pragma unroll
    for (int c = 1; c < NC; ++c) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) x[c][k] *= x[0][k];
    }
    return key_heads(key, before, i0, n, vec, stage);
  }
};

// count, then each weighted sum over max(count, 1).
template <int NC>
struct MeanStore {
  float* o[NC];

  __device__ __forceinline__ void operator()(
      long long i0, long long n, bool vec, const float (&s)[NC][kItems],
      uint4* stage) const {
    store_floats(o[0], i0, n, vec, s[0], stage);
#pragma unroll
    for (int c = 1; c < NC; ++c) {
      float m[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) m[k] = s[c][k] / fmaxf(s[0][k], 1.f);
      store_floats(o[c], i0, n, vec, m, stage);
    }
  }
};

template <int NC>
int launch(const int* keys, const float* w, const float* v0, const float* v1,
           float* o0, float* o1, float* o2, long long n, void* ws,
           unsigned long long base, int device, void* stream) {
  const MeanLoad<NC> load{keys, w, v0, v1};
  MeanStore<NC> store{};
  store.o[0] = o0;
  store.o[1] = o1;
  bool aligned = aligned16(keys) && aligned16(w) && aligned16(v0) &&
                 aligned16(o0) && aligned16(o1);
  if constexpr (NC == 3) {
    store.o[2] = o2;
    aligned = aligned && aligned16(v1) && aligned16(o2);
  }
  return launch_onepass<NC>(load, store, n, aligned, ws, base, device,
                            stream);
}

}  // namespace

extern "C" {

// nv = 1 or 2 value channels (v1 and o2 unused when nv = 1).  ws and base
// as for seg_scan_flags_f32 (seg_scan.cu).  Returns 0 or the cudaError_t of
// the launch; synchronizes nothing.
int seg_mean_f32(const void* keys, const void* w, const void* v0,
                 const void* v1, void* o0, void* o1, void* o2, long long n,
                 int nv, void* ws, unsigned long long base, int device,
                 void* stream) {
  auto* k = static_cast<const int*>(keys);
  auto* ww = static_cast<const float*>(w);
  auto* a = static_cast<const float*>(v0);
  auto* b = static_cast<const float*>(v1);
  auto* p0 = static_cast<float*>(o0);
  auto* p1 = static_cast<float*>(o1);
  auto* p2 = static_cast<float*>(o2);
  if (nv == 1) return launch<2>(k, ww, a, b, p0, p1, p2, n, ws, base, device,
                                stream);
  if (nv == 2) return launch<3>(k, ww, a, b, p0, p1, p2, n, ws, base, device,
                                stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
