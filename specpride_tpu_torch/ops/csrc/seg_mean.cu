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
// flops per element.  The three launches of seg_scan_core.cuh scan the
// channels (w, v_c * w); this file's fix-up adds the carry to each tile's
// leading run and divides every element.  That moves about 32 B/element for
// nv = 1 (reads 12 + writes 8 in pass 1, reads 8 + writes 4 and the leading
// runs' counts in pass 3): simple and exact for any run length; a
// single-pass decoupled look-back is the known way to reach the 20 B
// minimum.

#include "seg_scan_core.cuh"

namespace {

// Channels (w, v0 * w[, v1 * w]); a head where the key changes.
template <int NC>
struct MeanLoad {
  const int* keys;
  const float* w;
  const float* v0;
  const float* v1;

  __device__ __forceinline__ int operator()(long long i, float (&v)[NC]) const {
    const float ww = __ldg(w + i);
    v[0] = ww;
    v[1] = __ldg(v0 + i) * ww;
    if (NC == 3) v[NC - 1] = __ldg(v1 + i) * ww;
    return (i == 0) || (__ldg(keys + i) != __ldg(keys + i - 1));
  }
};

template <int NC>
__global__ void __launch_bounds__(kThreads)
seg_mean_fixup(Outs<NC> out, long long n, const int* __restrict__ tile_first,
               const float* __restrict__ carry) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long t = i / kTile;
  const bool lead = (int)(i - t * kTile) < tile_first[t];
  float s[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) s[c] = out.p[c][i];
  if (lead) {
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] += carry[t * NC + c];
    out.p[0][i] = s[0];
  }
  const float safe = fmaxf(s[0], 1.f);
#pragma unroll
  for (int c = 1; c < NC; ++c) out.p[c][i] = s[c] / safe;
}

template <int NC>
int launch(const int* keys, const float* w, const float* v0, const float* v1,
           float* o0, float* o1, float* o2, long long n, int* tile_first,
           float* tile_sum, cudaStream_t stream) {
  const MeanLoad<NC> load{keys, w, v0, v1};
  Outs<NC> out;
  out.p[0] = o0;
  out.p[1] = o1;
  if (NC == 3) out.p[NC - 1] = o2;
  cudaError_t err =
      launch_tile_scan<NC>(load, out, n, tile_first, tile_sum, stream);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + kThreads - 1) / kThreads;
  seg_mean_fixup<NC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      out, n, tile_first, tile_sum);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per tile: the caller allocates ceil(n / tile) ints and
// ceil(n / tile) * (1 + nv) floats of scratch.
int seg_mean_tile_size() { return kTile; }

// nv = 1 or 2 value channels (v1 and o2 unused when nv = 1).  Returns 0 or
// the cudaError_t of the first launch that failed; synchronizes nothing.
int seg_mean_f32(const void* keys, const void* w, const void* v0,
                 const void* v1, void* o0, void* o1, void* o2, long long n,
                 int nv, void* tile_first, void* tile_sum, void* stream) {
  if (n <= 0) return 0;
  if ((n + kTile - 1) / kTile > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<const int*>(keys);
  auto* ww = static_cast<const float*>(w);
  auto* a = static_cast<const float*>(v0);
  auto* b = static_cast<const float*>(v1);
  auto* p0 = static_cast<float*>(o0);
  auto* p1 = static_cast<float*>(o1);
  auto* p2 = static_cast<float*>(o2);
  auto* tf = static_cast<int*>(tile_first);
  auto* ts = static_cast<float*>(tile_sum);
  if (nv == 1) return launch<2>(k, ww, a, b, p0, p1, p2, n, tf, ts, s);
  if (nv == 2) return launch<3>(k, ww, a, b, p0, p1, p2, n, tf, ts, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
