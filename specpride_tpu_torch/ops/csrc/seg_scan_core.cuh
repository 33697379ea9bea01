// Single-pass segmented inclusive scan core shared by the port's CUDA
// kernels (seg_mean.cu, seg_scan.cu), for Hopper (sm_90a).
//
// The TPU kernels (specpride_tpu/ops/pallas_kernels.py, core
// _block_scan_chain) walk their grid in order and carry the open run's sums
// in SMEM from one block to the next.  Hopper runs blocks in parallel and in
// no order, so this core carries the open run between tiles inside one
// launch by decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", NVIDIA 2016), specialised to a
// segmented sum:
//   * each block takes its tile id from a ticket counter in the workspace,
//     not from blockIdx.x: a tile only ever waits on tiles whose blocks are
//     already running, whatever order the card starts blocks in;
//   * a tile is 2,048 elements: 128 threads each own 16 consecutive
//     elements, scanned in registers, then across the warp (shuffles) and
//     the block (one shared-memory step);
//   * a tile that holds a run head knows its inclusive prefix at once (the
//     sums of its trailing run) and publishes it before anything else; a
//     tile without one publishes its aggregate, looks back, then publishes
//     its inclusive prefix;
//   * only a tile whose first element is not a head needs a carry-in (for
//     its leading run).  One warp reads up to 32 predecessors' status words
//     per step and sums their aggregates back to the nearest inclusive
//     prefix.  With the path's runs of 1-20 that is the previous tile,
//     which holds a head and published as soon as its block scan was done;
//   * the STORE functor writes every output once, the carry already added
//     to the tile's leading run.
// A LOAD functor feeds the scan: load(i0, n, vec, x, stage) fills x[c][k]
// with element i0 + k's NC channel values and returns a mask whose bit k
// says that element i0 + k begins a run (element 0 always does).
//
// Load method: 16-byte vector loads into registers, coalesced per warp and
// regrouped through shared memory into each thread's consecutive elements,
// not a TMA bulk copy.  A tile waits only in its look-back, after its own
// loads and block scan, while the loads of the tiles resident beside it
// keep the memory busy: the kernels come close to the rate of a plain
// device copy of the same bytes (chip_smoke.py's copy_ms; PERF.md has the
// numbers), which bounds what a bulk copy could add.
//
// Workspace (one per device and stream, allocated and zeroed once by
// ops/kernels.py): record 0 holds the 64-bit ticket counter, then one
// 32-byte TileRec per tile: a status word and, in separate slots, the
// tile's aggregate sums and its inclusive prefix sums, so a reader never
// mixes the two.  A status word is (stamp << 2) | kind, stamp = the tile's
// ticket + 1, kind kAgg or kIncl.  The counter only grows and the caller
// passes its value before the launch (`base`), so a record left by an
// earlier call never reads as this call's and nothing is cleared between
// calls; the caller zeroes the workspace and restarts at base 0 before a
// stamp would reach 2^62.  Writers store the slot, then st.release the
// status word; readers ld.acquire the status word, then read the slot
// around L1 (__ldcg).
//
// Everything lies in an anonymous namespace: each source that includes this
// header gets its own kernels, so two translation units never share a
// template instantiation's registration.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The tile's shape, chosen on the H100 (PERF.md has the measurements:
// chip_smoke.py on copies with other values here): threads per block,
// elements per thread, and the blocks each SM must hold at once by channel
// count, which cap the registers a thread may use (1: no cap).
constexpr int kThreads = 128;
constexpr int kItems = 16;
constexpr int min_blocks(int nc) { return nc == 1 ? 12 : nc == 3 ? 6 : 1; }

constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxNC = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAgg = 1, kIncl = 2;
constexpr unsigned kMaxSpins = 1u << 24;  // of __nanosleep(32): over 0.5 s

static_assert(kItems == 4 || kItems == 8 || kItems == 16 || kItems == 32,
              "a thread's head mask is 32 bits and its loads 16 bytes wide");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

struct alignas(32) TileRec {
  unsigned long long status;
  float agg[kMaxNC];
  float incl[kMaxNC];
};
static_assert(sizeof(TileRec) == 32, "TileRec is the workspace's unit");

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
__device__ __forceinline__ Seg<NC> shfl_up(const Seg<NC>& x, int d) {
  Seg<NC> o;
  o.f = __shfl_up_sync(kFull, x.f, d);
#pragma unroll
  for (int c = 0; c < NC; ++c) o.v[c] = __shfl_up_sync(kFull, x.v[c], d);
  return o;
}

template <int NC>
__device__ __forceinline__ Seg<NC> warp_inclusive(Seg<NC> x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg<NC> o = shfl_up(x, d);
    if (lane >= d) seg_absorb(x, o);
  }
  return x;
}

// Exclusive segmented scan of one element per thread across the block;
// `total` gets the block's aggregate.  s_warp holds kWarps entries.
template <int NC>
__device__ __forceinline__ Seg<NC> block_exclusive(const Seg<NC>& x,
                                                   Seg<NC>* s_warp,
                                                   Seg<NC>& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Seg<NC> incl = warp_inclusive(x);
  Seg<NC> excl = shfl_up(incl, 1);
  if (lane == 0) excl = seg_identity<NC>();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Seg<NC> y = lane < kWarps ? s_warp[lane] : seg_identity<NC>();
    y = warp_inclusive(y);
    if (lane < kWarps) s_warp[lane] = y;
  }
  __syncthreads();
  if (warp > 0) seg_absorb(excl, s_warp[warp - 1]);
  total = s_warp[kWarps - 1];
  return excl;
}

// ---- loads and stores of one thread's kItems elements -------------------
// With `vec` the elements lie inside the array and every pointer is 16-byte
// aligned (a full tile); otherwise elements at or past n read as 0 and are
// not written.  `stage` is the warp's slice of shared memory (kStage
// uint4): 4-byte words move between memory and registers in coalesced
// 16-byte accesses (lane l takes the l-th 16 bytes of each 512-byte row of
// the warp's span) and are regrouped there into each thread's consecutive
// elements.  (Each thread reading its own consecutive 16-byte vectors would
// leave half of each 32-byte sector of a warp's access unused.)

constexpr int kVecs = kItems / 4;  // 16-byte vectors per thread
constexpr int kStage = 32 * kVecs;

// uint4 slot of vector f in a warp's stage: the XOR spreads both the
// row-wise writes and the thread-wise reads over all eight 16-byte bank
// groups (conflict-free for every kItems).
__device__ __forceinline__ int stage_slot(int f) { return f ^ ((f >> 3) & 7); }

// Start the loads of the thread's kItems 4-byte words.  With `vec`,
// w[4r..4r+3] then holds the warp's row r, lane-th vector; regroup() turns
// that into the thread's own consecutive elements.  A caller fetches every
// channel before regrouping any, so all of a tile's loads are in flight
// together.
__device__ __forceinline__ void fetch_words(const void* __restrict__ base,
                                            long long i0, long long n,
                                            bool vec, unsigned (&w)[kItems]) {
  const unsigned* p = static_cast<const unsigned*>(base);
  if (vec) {
    const int lane = threadIdx.x & 31;
    const uint4* q =
        reinterpret_cast<const uint4*>(p + i0 - (long long)lane * kItems) +
        lane;
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      const uint4 u = __ldg(q + r * 32);
      w[4 * r] = u.x;
      w[4 * r + 1] = u.y;
      w[4 * r + 2] = u.z;
      w[4 * r + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) w[k] = i0 + k < n ? __ldg(p + i0 + k) : 0u;
  }
}

__device__ __forceinline__ void regroup(unsigned (&w)[kItems], bool vec,
                                        uint4* stage) {
  if (!vec) return;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kVecs; ++r)
    stage[stage_slot(r * 32 + lane)] =
        make_uint4(w[4 * r], w[4 * r + 1], w[4 * r + 2], w[4 * r + 3]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const uint4 u = stage[stage_slot(lane * kVecs + k)];
    w[4 * k] = u.x;
    w[4 * k + 1] = u.y;
    w[4 * k + 2] = u.z;
    w[4 * k + 3] = u.w;
  }
  __syncwarp();
}

// Fetched, regrouped words as floats.
__device__ __forceinline__ void as_floats(unsigned (&w)[kItems], bool vec,
                                          uint4* stage, float (&x)[kItems]) {
  regroup(w, vec, stage);
#pragma unroll
  for (int k = 0; k < kItems; ++k) x[k] = __uint_as_float(w[k]);
}

__device__ __forceinline__ void store_floats(float* __restrict__ p,
                                             long long i0, long long n,
                                             bool vec,
                                             const float (&x)[kItems],
                                             uint4* stage) {
  if (vec) {
    const int lane = threadIdx.x & 31;
    uint4 u[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      u[k] = make_uint4(__float_as_uint(x[4 * k]), __float_as_uint(x[4 * k + 1]),
                        __float_as_uint(x[4 * k + 2]),
                        __float_as_uint(x[4 * k + 3]));
#pragma unroll
    for (int k = 0; k < kVecs; ++k) stage[stage_slot(lane * kVecs + k)] = u[k];
    __syncwarp();
    uint4* row = reinterpret_cast<uint4*>(p + i0 - (long long)lane * kItems);
#pragma unroll
    for (int r = 0; r < kVecs; ++r)
      row[r * 32 + lane] = stage[stage_slot(r * 32 + lane)];
    __syncwarp();
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (i0 + k < n) p[i0 + k] = x[k];
  }
}

// Heads where a byte is nonzero.  A thread's kItems flag bytes are one
// 4- to 32-byte vector, so a warp's loads are contiguous without staging.
__device__ __forceinline__ unsigned flag_heads(
    const unsigned char* __restrict__ head, long long i0, long long n,
    bool vec) {
  unsigned m = 0;
  if (vec) {
    unsigned w[kItems / 4];
    if constexpr (kItems % 16 == 0) {
      const uint4* q = reinterpret_cast<const uint4*>(head + i0);
#pragma unroll
      for (int k = 0; k < kItems / 16; ++k) {
        const uint4 u = __ldg(q + k);
        w[4 * k] = u.x;
        w[4 * k + 1] = u.y;
        w[4 * k + 2] = u.z;
        w[4 * k + 3] = u.w;
      }
    } else if constexpr (kItems == 8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(head + i0));
      w[0] = u.x;
      w[1] = u.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(head + i0));
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if ((w[k >> 2] >> (8 * (k & 3))) & 0xffu) m |= 1u << k;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (i0 + k < n && __ldg(head + i0 + k) != 0) m |= 1u << k;
  }
  return i0 == 0 ? m | 1u : m;
}

// The key before element i0 (fetched with the tile's loads), for
// key_heads; unused at element 0.
__device__ __forceinline__ unsigned key_before(const int* __restrict__ keys,
                                               long long i0, long long n) {
  return i0 > 0 && i0 < n ? (unsigned)__ldg(keys + i0 - 1) : 0u;
}

// Heads where a (fetched) key differs from the key before it.
__device__ __forceinline__ unsigned key_heads(unsigned (&key)[kItems],
                                              unsigned before, long long i0,
                                              long long n, bool vec,
                                              uint4* stage) {
  regroup(key, vec, stage);
  unsigned prev = i0 == 0 ? ~key[0] : before;  // element 0 always begins
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((vec || i0 + k < n) && key[k] != prev) m |= 1u << k;
    prev = key[k];
  }
  return m;
}

// ---- the look-back protocol ---------------------------------------------

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// One thread: the slot, then the status word that announces it.  The
// release store orders the slot's stores before it at gpu scope, so no
// __threadfence() is needed between them.
template <int NC>
__device__ __forceinline__ void publish(TileRec* r, unsigned long long stamp,
                                        unsigned long long kind,
                                        const float (&v)[NC]) {
  float* slot = kind == kIncl ? r->incl : r->agg;
#pragma unroll
  for (int c = 0; c < NC; ++c) slot[c] = v[c];
  st_release(&r->status, (stamp << 2) | kind);
}

// One whole warp: the carry-in of tile t, the sums of the run open at its
// start.  Lane l reads tile p - l; a window is usable once every tile up to
// the nearest inclusive prefix has published; aggregates before it (no
// head, by construction) add plainly.
template <int NC>
__device__ void look_back(const TileRec* __restrict__ recs, long long t,
                          unsigned long long base, float (&carry)[NC]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NC; ++c) carry[c] = 0.f;
  for (long long p = t - 1;; p -= 32) {
    const long long q = p - lane;
    unsigned incl;
    for (unsigned spins = 0;; ++spins) {
      // a predecessor publishes within microseconds of its block scan; a
      // wait of a second means a broken protocol: fail the launch rather
      // than hang the card
      if (spins == kMaxSpins) __trap();
      unsigned long long kind = kIncl;  // before tile 0: adds nothing
      if (q >= 0) {
        const unsigned long long st = ld_acquire(&recs[q].status);
        kind = (st >> 2) == base + (unsigned long long)q + 1ull ? (st & 3ull)
                                                                : 0ull;
      }
      incl = __ballot_sync(kFull, kind == kIncl);
      const unsigned pending = __ballot_sync(kFull, kind == 0ull);
      const unsigned need = incl ? (incl ^ (incl - 1u)) : kFull;
      if (!(pending & need)) break;
      __nanosleep(32);
    }
    const int stop = incl ? __ffs(incl) - 1 : 32;
    float v[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = 0.f;
    if (q >= 0 && lane <= stop) {
      const float* slot = lane == stop ? recs[q].incl : recs[q].agg;
#pragma unroll
      for (int c = 0; c < NC; ++c) v[c] = __ldcg(slot + c);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        v[c] += __shfl_xor_sync(kFull, v[c], d);
      carry[c] += v[c];
    }
    if (incl) return;
  }
}

// ---- the kernel -----------------------------------------------------------

template <int NC, class Load, class Store>
__global__ void __launch_bounds__(kThreads, min_blocks(NC))
seg_onepass(Load load, Store store, long long n,
            unsigned long long* __restrict__ ticket,
            TileRec* __restrict__ recs, unsigned long long base,
            bool aligned) {
  __shared__ Seg<NC> s_warp[kWarps];
  __shared__ uint4 s_stage[kWarps][kStage];
  __shared__ long long s_tile;
  __shared__ float s_carry[NC];
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = (long long)(atomicAdd(ticket, 1ull) - base);
  __syncthreads();
  const long long t = s_tile;
  const long long i0 = t * kTile + (long long)tid * kItems;
  const bool vec = aligned && (t + 1) * kTile <= n;

  uint4* stage = s_stage[tid >> 5];
  float x[NC][kItems];
  const unsigned heads = load(i0, n, vec, x, stage);

  // the thread's own elements: local prefixes and its aggregate
  Seg<NC> own;
  own.f = heads != 0u;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      run = ((heads >> k) & 1u) ? x[c][k] : run + x[c][k];
      x[c][k] = run;
    }
    own.v[c] = run;
  }
  Seg<NC> total;
  const Seg<NC> excl = block_exclusive(own, s_warp, total);

  if (tid < 32) {
    const unsigned long long stamp = base + (unsigned long long)t + 1ull;
    // a carry is needed unless the tile begins with a head (tile 0 does)
    const bool lead = __shfl_sync(kFull, (heads & 1u) == 0u, 0);
    if (tid == 0) publish<NC>(recs + t, stamp, total.f ? kIncl : kAgg, total.v);
    float carry[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) carry[c] = 0.f;
    if (lead) {
      look_back<NC>(recs, t, base, carry);
      if (tid == 0 && !total.f) {
        float incl[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) incl[c] = carry[c] + total.v[c];
        publish<NC>(recs + t, stamp, kIncl, incl);
      }
    }
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) s_carry[c] = carry[c];
    }
  }
  __syncthreads();

  // the elements before the thread's first head take the block prefix and,
  // when no head precedes them in the tile, the carry
  const unsigned before_head = heads ? (heads & (0u - heads)) - 1u : kFull;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float add = excl.v[c] + (excl.f ? 0.f : s_carry[c]);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if ((before_head >> k) & 1u) x[c][k] += add;
  }
  if (vec || i0 < n) store(i0, n, vec, x, stage);
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// One launch of seg_onepass over n elements on `stream` of `device`.
// Returns 0 or the cudaError_t of the launch; synchronizes nothing.
template <int NC, class Load, class Store>
int launch_onepass(const Load& load, const Store& store, long long n,
                   bool aligned, void* ws, unsigned long long base,
                   int device, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto* ticket = static_cast<unsigned long long*>(ws);
  auto* recs = static_cast<TileRec*>(ws) + 1;
  seg_onepass<NC, Load, Store>
      <<<(unsigned)tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          load, store, n, ticket, recs, base, aligned);
  err = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return (int)err;
}

}  // namespace
