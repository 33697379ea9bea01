// Segmented inclusive scan core shared by the port's CUDA kernels
// (seg_mean.cu, seg_scan.cu), for Hopper (sm_90a).
//
// The TPU kernels (specpride_tpu/ops/pallas_kernels.py, core
// _block_scan_chain) walk their grid in order and carry the open run's sums
// in SMEM.  Hopper runs blocks in parallel and in no order, so a scan over N
// elements takes three launches here:
//   1. seg_tile_scan: per tile of kTile elements, a segmented inclusive scan
//      of NC channels in shared memory and warp shuffles, written to the
//      outputs, plus each tile's aggregate: the position of its first run
//      head and the sums of its trailing run;
//   2. seg_tile_carry: one block scans the aggregates into each tile's
//      carry-in, the open run's sums entering the tile; a tile with no head
//      passes its carry through, so a run across many tiles chains;
//   3. a fix-up, the caller's, adds the carry to each tile's leading run
//      (seg_fixup_add below; seg_mean.cu's also divides).
// Exact for any run length and any N.  A LOAD functor feeds pass 1:
// load(i, v) writes element i's NC channel values into v and returns
// whether i begins a run.
//
// Everything lies in an anonymous namespace: each source that includes this
// header gets its own kernels, so two translation units never share a
// template instantiation's registration.

#pragma once

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

// The NC output channels of a scan, passed to a kernel by value.
template <int NC>
struct Outs {
  float* p[NC];
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

template <int NC, class Load>
__global__ void __launch_bounds__(kThreads)
seg_tile_scan(Load load, Outs<NC> out, long long n,
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

  // coalesced (striped) load into shared memory; slots past n hold 0
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + tid;
    const long long i = base + j;
    float v[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = 0.f;
    int head = 0;
    if (i < n) head = load(i, v);
#pragma unroll
    for (int c = 0; c < NC; ++c) s_val[c][j] = v[c];
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

  // coalesced store of the tile-local prefixes
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + tid;
    const long long i = base + j;
    if (i < n) {
#pragma unroll
      for (int c = 0; c < NC; ++c) out.p[c][i] = s_val[c][j];
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

// Pass 3 of a plain scan, one block per tile: adds the tile's carry-in to
// its leading run, the elements before its first head.  Other elements are
// final after pass 1 and are neither read nor written.
template <int NC>
__global__ void __launch_bounds__(kThreads)
seg_fixup_add(Outs<NC> out, long long n, const int* __restrict__ tile_first,
              const float* __restrict__ carry) {
  const long long t = blockIdx.x;
  const long long base = t * kTile;
  const long long lead = min((long long)tile_first[t], n - base);
  float add[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) add[c] = carry[t * NC + c];
  for (long long j = threadIdx.x; j < lead; j += kThreads) {
#pragma unroll
    for (int c = 0; c < NC; ++c) out.p[c][base + j] += add[c];
  }
}

// Passes 1 and 2; the caller launches its fix-up after.  Returns the
// cudaError_t of the first launch that failed, or cudaSuccess.
template <int NC, class Load>
cudaError_t launch_tile_scan(const Load& load, Outs<NC> out, long long n,
                             int* tile_first, float* tile_sum,
                             cudaStream_t stream) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  seg_tile_scan<NC, Load><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      load, out, n, tile_first, tile_sum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seg_tile_carry<NC><<<1, kCarryThreads, 0, stream>>>(tile_first, tile_sum,
                                                      (int)n_tiles);
  return cudaGetLastError();
}

}  // namespace
