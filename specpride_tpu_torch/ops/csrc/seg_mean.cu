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
// flops per element.  The TPU kernel walks its grid in order and carries
// the open run's sums in SMEM; Hopper runs blocks in parallel and in no
// order, so this port takes three launches:
//   1. seg_tile_scan: per tile of TILE elements, a segmented inclusive
//      scan of (w, v_c * w) in shared memory and warp shuffles, written
//      un-divided to the outputs, plus each tile's aggregate: the position
//      of its first run head and the sums of its trailing run;
//   2. seg_tile_carry: one block scans the aggregates into each tile's
//      carry-in; a tile with no head passes its carry through;
//   3. seg_fixup: adds the carry to each tile's leading run, then divides.
// That moves about 32 B/element for nv = 1 (reads 12 + writes 8 in pass 1,
// reads 8 + writes 4 and the leading runs' counts in pass 3): simple and
// exact for any run length; a single-pass decoupled look-back is the
// known way to reach the 20 B minimum.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// One segmented-scan element: a head flag and NC running sums.
template <int NC>
struct Seg {
  int f;
  float v[NC];
};

template <int NC>
__device__ __forceinline__ Seg<NC> seg_identity() {
  Seg<NC> s;
  s.f = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) s.v[c] = 0.f;
  return s;
}

// later := earlier (+) later, the segmented-sum operator (associative).
template <int NC>
__device__ __forceinline__ void seg_absorb(Seg<NC>& later,
                                           const Seg<NC>& earlier) {
  if (!later.f) {
#pragma unroll
    for (int c = 0; c < NC; ++c) later.v[c] += earlier.v[c];
  }
  later.f |= earlier.f;
}

template <int NC>
__device__ __forceinline__ Seg<NC> warp_inclusive(Seg<NC> x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Seg<NC> o;
    o.f = __shfl_up_sync(kFull, x.f, d);
#pragma unroll
    for (int c = 0; c < NC; ++c) o.v[c] = __shfl_up_sync(kFull, x.v[c], d);
    if (lane >= d) seg_absorb(x, o);
  }
  return x;
}

// Block-wide inclusive segmented scan; s_warp holds THREADS / 32 entries.
// Ends with a barrier, so s_warp may be reused right after.
template <int NC, int THREADS>
__device__ Seg<NC> block_inclusive(Seg<NC> x, Seg<NC>* s_warp) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_inclusive(x);
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Seg<NC> y = lane < kWarps ? s_warp[lane] : seg_identity<NC>();
    y = warp_inclusive(y);
    if (lane < kWarps) s_warp[lane] = y;
  }
  __syncthreads();
  if (warp > 0) seg_absorb(x, s_warp[warp - 1]);
  __syncthreads();
  return x;
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
seg_tile_scan(const int* __restrict__ keys, const float* __restrict__ w,
              const float* __restrict__ v0, const float* __restrict__ v1,
              float* __restrict__ o0, float* __restrict__ o1,
              float* __restrict__ o2, long long n,
              int* __restrict__ tile_first, float* __restrict__ tile_sum) {
  __shared__ float s_val[NC][kTile];
  __shared__ unsigned char s_head[kTile];
  __shared__ Seg<NC> s_warp[kThreads / 32];
  __shared__ Seg<NC> s_thr[kThreads];
  __shared__ int s_first;

  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * kTile;
  if (tid == 0) s_first = kTile;
  __syncthreads();

  // coalesced (striped) load into shared memory; slots past n weigh 0
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + tid;
    const long long i = base + j;
    float ww = 0.f, a = 0.f, b = 0.f;
    int head = 0;
    if (i < n) {
      ww = w[i];
      a = v0[i] * ww;
      if (NC == 3) b = v1[i] * ww;
      head = (i == 0) || (keys[i] != keys[i - 1]);
    }
    s_val[0][j] = ww;
    s_val[1][j] = a;
    if (NC == 3) s_val[NC - 1][j] = b;
    s_head[j] = (unsigned char)head;
    if (head) atomicMin(&s_first, j);
  }
  __syncthreads();

  // each thread owns kItems consecutive elements: local aggregate first
  Seg<NC> agg = seg_identity<NC>();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid * kItems + k;
    if (s_head[j]) {
      agg.f = 1;
#pragma unroll
      for (int c = 0; c < NC; ++c) agg.v[c] = s_val[c][j];
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) agg.v[c] += s_val[c][j];
    }
  }
  const Seg<NC> incl = block_inclusive<NC, kThreads>(agg, s_warp);
  s_thr[tid] = incl;
  __syncthreads();
  const Seg<NC> excl = tid > 0 ? s_thr[tid - 1] : seg_identity<NC>();

  // rescan the owned elements from the thread's exclusive prefix
  float run[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) run[c] = excl.v[c];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid * kItems + k;
    const bool head = s_head[j];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      run[c] = head ? s_val[c][j] : run[c] + s_val[c][j];
      s_val[c][j] = run[c];
    }
  }
  __syncthreads();

  // coalesced store of the un-divided prefixes
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + tid;
    const long long i = base + j;
    if (i < n) {
      o0[i] = s_val[0][j];
      o1[i] = s_val[1][j];
      if (NC == 3) o2[i] = s_val[NC - 1][j];
    }
  }
  if (tid == kThreads - 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tile_sum[(long long)blockIdx.x * NC + c] = incl.v[c];
  }
  if (tid == 0) tile_first[blockIdx.x] = s_first;
}

// One block: tile_sum (trailing-run sums) is turned in place into each
// tile's carry-in, the open run's sums entering the tile.
template <int NC>
__global__ void __launch_bounds__(kCarryThreads)
seg_tile_carry(const int* __restrict__ tile_first, float* tile_sum,
               int n_tiles) {
  __shared__ Seg<NC> s_warp[kCarryThreads / 32];
  __shared__ Seg<NC> s_thr[kCarryThreads];
  const int tid = threadIdx.x;
  float carry[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) carry[c] = 0.f;

  for (int start = 0; start < n_tiles; start += kCarryThreads) {
    const int t = start + tid;
    Seg<NC> x = seg_identity<NC>();
    if (t < n_tiles) {
      x.f = tile_first[t] < kTile;
#pragma unroll
      for (int c = 0; c < NC; ++c) x.v[c] = tile_sum[(long long)t * NC + c];
    }
    const Seg<NC> incl = block_inclusive<NC, kCarryThreads>(x, s_warp);
    s_thr[tid] = incl;
    __syncthreads();
    const Seg<NC> excl = tid > 0 ? s_thr[tid - 1] : seg_identity<NC>();
    if (t < n_tiles) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tile_sum[(long long)t * NC + c] = excl.f ? excl.v[c] : carry[c] + excl.v[c];
    }
    const Seg<NC> last = s_thr[kCarryThreads - 1];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      carry[c] = last.f ? last.v[c] : carry[c] + last.v[c];
    __syncthreads();
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
seg_fixup(float* __restrict__ o0, float* __restrict__ o1,
          float* __restrict__ o2, long long n,
          const int* __restrict__ tile_first,
          const float* __restrict__ carry) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long t = i / kTile;
  const bool lead = (int)(i - t * kTile) < tile_first[t];
  float cnt = o0[i];
  float s1 = o1[i];
  float s2 = NC == 3 ? o2[i] : 0.f;
  if (lead) {
    cnt += carry[t * NC];
    s1 += carry[t * NC + 1];
    if (NC == 3) s2 += carry[t * NC + NC - 1];
    o0[i] = cnt;
  }
  const float safe = fmaxf(cnt, 1.f);
  o1[i] = s1 / safe;
  if (NC == 3) o2[i] = s2 / safe;
}

template <int NC>
int launch(const int* keys, const float* w, const float* v0, const float* v1,
           float* o0, float* o1, float* o2, long long n, int* tile_first,
           float* tile_sum, cudaStream_t stream) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  seg_tile_scan<NC><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      keys, w, v0, v1, o0, o1, o2, n, tile_first, tile_sum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_tile_carry<NC><<<1, kCarryThreads, 0, stream>>>(tile_first, tile_sum,
                                                      (int)n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + kThreads - 1) / kThreads;
  seg_fixup<NC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      o0, o1, o2, n, tile_first, tile_sum);
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
