// Segmented inclusive prefix sums, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel specpride_tpu/ops/pallas_kernels.py
// seg_scan_pallas (body _seg_scan_block_kernel, core _block_scan_chain),
// and with it the XLA scan specpride_tpu/ops/segments.py seg_scan that the
// flat QC cosine calls five times per chunk.  Per element i and channel c,
//   out_c[i] = sum of v_c over i's run, from the run's head through i,
// in f32, for 1 to 3 channels, exact for any run length and any N.  The runs
// come in one of two forms, one entry point each:
//   * head flags, (N,) bytes, nonzero where a run begins (element 0 always
//     begins one): what the cosine's runs need, since they come from
//     composite keys and row and spectrum starts;
//   * sorted int32 keys, a head where key[i] != key[i-1]: what
//     seg_scan_pallas takes (it compares with each row's first key, the
//     same runs for sorted keys and for a -1 padding tail).
//
// Bound: memory.  The function reads the run form and nc channels and
// writes nc outputs: (1 + 8 nc) B/element with flags, (4 + 8 nc) with keys,
// 28 B for seg_scan_pallas's three channels; a handful of adds per element.
// One launch of seg_scan_core.cuh's single-pass scan: each input is read
// once with 16-byte loads and each output written once, so the traffic is
// the bound's plus a 32-byte record per tile; at the cosine's ~3M elements
// the rest of a call's time is the launch itself.

#include "seg_scan_core.cuh"

namespace {

template <int NC>
struct FlagLoad {
  const unsigned char* head;
  const float* v[NC];

  __device__ __forceinline__ unsigned operator()(
      long long i0, long long n, bool vec, float (&x)[NC][kItems],
      uint4* stage) const {
    unsigned w[NC][kItems];
#pragma unroll
    for (int c = 0; c < NC; ++c) fetch_words(v[c], i0, n, vec, w[c]);
    const unsigned heads = flag_heads(head, i0, n, vec);
#pragma unroll
    for (int c = 0; c < NC; ++c) as_floats(w[c], vec, stage, x[c]);
    return heads;
  }
};

template <int NC>
struct KeyLoad {
  const int* keys;
  const float* v[NC];

  __device__ __forceinline__ unsigned operator()(
      long long i0, long long n, bool vec, float (&x)[NC][kItems],
      uint4* stage) const {
    unsigned key[kItems], w[NC][kItems];
    fetch_words(keys, i0, n, vec, key);
    const unsigned before = key_before(keys, i0, n);
#pragma unroll
    for (int c = 0; c < NC; ++c) fetch_words(v[c], i0, n, vec, w[c]);
#pragma unroll
    for (int c = 0; c < NC; ++c) as_floats(w[c], vec, stage, x[c]);
    return key_heads(key, before, i0, n, vec, stage);
  }
};

template <int NC>
struct ScanStore {
  float* o[NC];

  __device__ __forceinline__ void operator()(
      long long i0, long long n, bool vec, const float (&s)[NC][kItems],
      uint4* stage) const {
#pragma unroll
    for (int c = 0; c < NC; ++c) store_floats(o[c], i0, n, vec, s[c], stage);
  }
};

template <int NC, template <int> class L, class R>
int launch(const R* runs, const void* const* in, void* const* out,
           long long n, void* ws, unsigned long long base, int device,
           void* stream) {
  L<NC> load{runs, {}};
  ScanStore<NC> store{};
  bool aligned = aligned16(runs);
  for (int c = 0; c < NC; ++c) {
    load.v[c] = static_cast<const float*>(in[c]);
    store.o[c] = static_cast<float*>(out[c]);
    aligned = aligned && aligned16(in[c]) && aligned16(out[c]);
  }
  return launch_onepass<NC>(load, store, n, aligned, ws, base, device,
                            stream);
}

template <template <int> class L, class R>
int dispatch(const R* runs, const void* v0, const void* v1, const void* v2,
             void* o0, void* o1, void* o2, long long n, int nc, void* ws,
             unsigned long long base, int device, void* stream) {
  const void* in[kMaxNC] = {v0, v1, v2};
  void* out[kMaxNC] = {o0, o1, o2};
  switch (nc) {
    case 1:
      return launch<1, L>(runs, in, out, n, ws, base, device, stream);
    case 2:
      return launch<2, L>(runs, in, out, n, ws, base, device, stream);
    case 3:
      return launch<3, L>(runs, in, out, n, ws, base, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Elements per tile, and bytes of workspace per tile: a call over n
// elements needs (1 + ceil(n / tile)) records, zeroed before first use.
int seg_tile_size() { return kTile; }
int seg_record_bytes() { return (int)sizeof(TileRec); }

// nc = 1..3 channels; the v and o pointers past nc are unused.  ws is the
// stream's workspace and base its ticket counter's value before this
// launch, which adds ceil(n / tile) to it.  Returns 0 or the cudaError_t of
// the launch; synchronizes nothing.
int seg_scan_flags_f32(const void* head, const void* v0, const void* v1,
                       const void* v2, void* o0, void* o1, void* o2,
                       long long n, int nc, void* ws, unsigned long long base,
                       int device, void* stream) {
  return dispatch<FlagLoad>(static_cast<const unsigned char*>(head), v0, v1,
                            v2, o0, o1, o2, n, nc, ws, base, device, stream);
}

int seg_scan_keys_f32(const void* keys, const void* v0, const void* v1,
                      const void* v2, void* o0, void* o1, void* o2,
                      long long n, int nc, void* ws, unsigned long long base,
                      int device, void* stream) {
  return dispatch<KeyLoad>(static_cast<const int*>(keys), v0, v1, v2, o0, o1,
                           o2, n, nc, ws, base, device, stream);
}

}  // extern "C"
