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
// The three launches of seg_scan_core.cuh: pass 1 writes every element's
// tile-local prefix, which is final except in each tile's leading run, so
// the fix-up touches only those leading runs.  The traffic is the bound's
// plus the tile aggregates and the leading runs; the two extra launches are
// what costs at the cosine's ~3M elements.

#include "seg_scan_core.cuh"

namespace {

template <int NC>
struct FlagLoad {
  const unsigned char* head;
  const float* v[NC];

  __device__ __forceinline__ int operator()(long long i, float (&x)[NC]) const {
#pragma unroll
    for (int c = 0; c < NC; ++c) x[c] = __ldg(v[c] + i);
    return (i == 0) || (__ldg(head + i) != 0);
  }
};

template <int NC>
struct KeyLoad {
  const int* keys;
  const float* v[NC];

  __device__ __forceinline__ int operator()(long long i, float (&x)[NC]) const {
#pragma unroll
    for (int c = 0; c < NC; ++c) x[c] = __ldg(v[c] + i);
    return (i == 0) || (__ldg(keys + i) != __ldg(keys + i - 1));
  }
};

template <int NC, class Load>
int launch(Load load, void* const* outs, long long n, int* tile_first,
           float* tile_sum, cudaStream_t stream) {
  Outs<NC> out;
  for (int c = 0; c < NC; ++c) out.p[c] = static_cast<float*>(outs[c]);
  cudaError_t err =
      launch_tile_scan<NC>(load, out, n, tile_first, tile_sum, stream);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + kTile - 1) / kTile;
  seg_fixup_add<NC><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      out, n, tile_first, tile_sum);
  return (int)cudaGetLastError();
}

template <template <int> class L, class H>
int dispatch(const H* runs, void* const* values, void* const* outs,
             long long n, int nc, void* tile_first, void* tile_sum,
             void* stream) {
  if (n <= 0) return 0;
  if ((n + kTile - 1) / kTile > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* tf = static_cast<int*>(tile_first);
  auto* ts = static_cast<float*>(tile_sum);
  switch (nc) {
    case 1: {
      L<1> load{runs, {static_cast<const float*>(values[0])}};
      return launch<1>(load, outs, n, tf, ts, s);
    }
    case 2: {
      L<2> load{runs, {static_cast<const float*>(values[0]),
                       static_cast<const float*>(values[1])}};
      return launch<2>(load, outs, n, tf, ts, s);
    }
    case 3: {
      L<3> load{runs, {static_cast<const float*>(values[0]),
                       static_cast<const float*>(values[1]),
                       static_cast<const float*>(values[2])}};
      return launch<3>(load, outs, n, tf, ts, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Elements per tile: the caller allocates ceil(n / tile) ints and
// ceil(n / tile) * nc floats of scratch.
int seg_scan_tile_size() { return kTile; }

// values and outs are host arrays of nc device pointers (nc = 1..3).
// Returns 0 or the cudaError_t of the first launch that failed;
// synchronizes nothing.
int seg_scan_flags_f32(const void* head, void* const* values,
                       void* const* outs, long long n, int nc,
                       void* tile_first, void* tile_sum, void* stream) {
  return dispatch<FlagLoad>(static_cast<const unsigned char*>(head), values,
                            outs, n, nc, tile_first, tile_sum, stream);
}

int seg_scan_keys_f32(const void* keys, void* const* values,
                      void* const* outs, long long n, int nc,
                      void* tile_first, void* tile_sum, void* stream) {
  return dispatch<KeyLoad>(static_cast<const int*>(keys), values, outs, n,
                           nc, tile_first, tile_sum, stream);
}

}  // extern "C"
