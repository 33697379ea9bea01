// Fused segmented mean, for Hopper (sm_90a), in two entries.
//
// Replaces the Pallas TPU kernel specpride_tpu/ops/pallas_kernels.py
// seg_mean_pallas (body _seg_mean_block_kernel, core _block_scan_chain).
//
// seg_mean_f32: runs are maximal spans of equal ADJACENT int32 keys, with
// a float32 weight w.  Per element i:
//   count[i]  = sum of w over the run from its start through i
//   mean_c[i] = (sum of v_c * w over the same span) / max(count[i], 1)
// so the value at a run's last element is the run's weighted mean.  A
// zero-weight slot inside a run reads the count of the valid slots before
// it; a run masked from its start reads count 0 / mean 0.
//
// seg_mean_heads: runs begin where a 1-byte head flag is nonzero (element 0
// always begins one) and every element weighs 1; the value channels are
// float32, bf16 or int8, upcast to f32 in registers as the TPU kernel does
// after astype(float32).  This is the function the JAX package computes
// with seg_mean_pallas for the reduced-precision binned mean (a cumsum key
// of the run-start mask, specpride_tpu/ops/binning.py:183-189) and the gap
// average (a (row, segment) composite key, ops/gap_average.py:103-122):
// the port's flat layouts have no padding slot, so no weight channel.
//
// Bound: memory.  seg_mean_f32 must read key, w and nv values and write
// 1 + nv outputs: 20 B/element for nv = 1, 28 B for nv = 2.
// seg_mean_heads reads 1 B of flags and 1, 2 or 4 B per value and writes
// 4 (1 + nv) B: 11 B/element for one bf16 channel, 10 for int8, 21 for f32
// m/z and intensity, 18 for f32 m/z and int8 intensity.  A few flops per
// element either way.  Each is one launch of seg_scan_core.cuh's
// single-pass scan; the store divides, after the carry has reached the
// tile's leading run, so every input is read once and every output
// written once: the bound's bytes plus a 32-byte record per tile.  The
// narrow channels load each thread's own 16 or 32 consecutive bytes (one
// or two 16-byte vectors), like the head flags.

#include <type_traits>

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

// ---- seg_mean_heads ---------------------------------------------------

using bf16_bits = unsigned short;  // a bfloat16 as its bit pattern

__device__ __forceinline__ float upcast(bf16_bits b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ float upcast(signed char c) {
  return static_cast<float>(c);
}

// A thread's kItems values of a 1- or 2-byte channel, upcast.  With `vec`
// they are the thread's own kItems * sizeof(T) consecutive bytes, one or
// two 16-byte vectors (a warp's loads are then contiguous without
// staging); otherwise element by element, elements at or past n as 0.
template <class T>
__device__ __forceinline__ void narrow_floats(const T* __restrict__ p,
                                              long long i0, long long n,
                                              bool vec, float (&x)[kItems]) {
  constexpr int kPer = 4 / sizeof(T);  // values per 32-bit word
  static_assert(kItems * sizeof(T) % 16 == 0, "whole 16-byte vectors");
  if (vec) {
    unsigned w[kItems / kPer];
    const uint4* q = reinterpret_cast<const uint4*>(p + i0);
#pragma unroll
    for (int r = 0; r < kItems / kPer / 4; ++r) {
      const uint4 u = __ldg(q + r);
      w[4 * r] = u.x;
      w[4 * r + 1] = u.y;
      w[4 * r + 2] = u.z;
      w[4 * r + 3] = u.w;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      x[k] = upcast(
          static_cast<T>(w[k / kPer] >> (8 * sizeof(T) * (k % kPer))));
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      x[k] = i0 + k < n ? upcast(__ldg(p + i0 + k)) : 0.f;
  }
}

// Channels (1, v0[, v1]) with v_c of type A, B (float, bf16_bits or signed
// char); heads where a flag byte is nonzero.  Every channel's loads are
// issued before any is regrouped.
template <int NC, class A, class B>
struct HeadLoad {
  const unsigned char* head;
  const A* v0;
  const B* v1;

  __device__ __forceinline__ unsigned operator()(
      long long i0, long long n, bool vec, float (&x)[NC][kItems],
      uint4* stage) const {
    constexpr bool kWide0 = std::is_same_v<A, float>;
    constexpr bool kWide1 = NC == 3 && std::is_same_v<B, float>;
    unsigned w0[kItems], w1[kItems];
    if constexpr (kWide0) fetch_words(v0, i0, n, vec, w0);
    if constexpr (kWide1) fetch_words(v1, i0, n, vec, w1);
    if constexpr (!kWide0) narrow_floats(v0, i0, n, vec, x[1]);
    if constexpr (NC == 3 && !kWide1) narrow_floats(v1, i0, n, vec, x[2]);
    const unsigned heads = flag_heads(head, i0, n, vec);
    if constexpr (kWide0) as_floats(w0, vec, stage, x[1]);
    if constexpr (kWide1) as_floats(w1, vec, stage, x[2]);
#pragma unroll
    for (int k = 0; k < kItems; ++k) x[0][k] = vec || i0 + k < n ? 1.f : 0.f;
    return heads;
  }
};

struct HeadArgs {
  const void* head;
  const void* v0;
  const void* v1;
  float* o[3];
  long long n;
  void* ws;
  unsigned long long base;
  int device;
  void* stream;
};

template <int NC, class A, class B = float>
int launch_heads(const HeadArgs& a) {
  const HeadLoad<NC, A, B> load{static_cast<const unsigned char*>(a.head),
                                static_cast<const A*>(a.v0),
                                static_cast<const B*>(a.v1)};
  MeanStore<NC> store{};
  bool aligned = aligned16(a.head);
  for (int c = 0; c < NC; ++c) {
    store.o[c] = a.o[c];
    aligned = aligned && aligned16(a.o[c]);
  }
  aligned = aligned && aligned16(a.v0) && (NC == 2 || aligned16(a.v1));
  return launch_onepass<NC>(load, store, a.n, aligned, a.ws, a.base,
                            a.device, a.stream);
}

// Channel kinds: kinds = kind of v0 | kind of v1 << 4 (0: no v1).
constexpr int kF32 = 1, kBF16 = 2, kI8 = 3;

constexpr int kinds2(int a, int b) { return a | b << 4; }

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

// One f32, bf16 or int8 channel (the gap average's and the reduced binned
// mean's intensities), or two: f32 m/z and f32 intensity, or f32 or bf16
// m/z and bf16 or int8 intensity (`kinds`, above).  Outputs o0 = count, o1[, o2] = means,
// f32; in2 is unused.  ws and base as for seg_scan_flags_f32 (seg_scan.cu).
// Returns 0 or the cudaError_t of the launch (cudaErrorInvalidValue for
// another combination); synchronizes nothing.
int seg_mean_heads(const void* head, const void* v0, const void* v1,
                   const void* in2, void* o0, void* o1, void* o2, long long n,
                   int kinds, void* ws, unsigned long long base, int device,
                   void* stream) {
  (void)in2;
  const HeadArgs a{head, v0, v1,
                   {static_cast<float*>(o0), static_cast<float*>(o1),
                    static_cast<float*>(o2)},
                   n, ws, base, device, stream};
  switch (kinds) {
    case kF32: return launch_heads<2, float>(a);
    case kBF16: return launch_heads<2, bf16_bits>(a);
    case kI8: return launch_heads<2, signed char>(a);
    case kinds2(kF32, kF32): return launch_heads<3, float, float>(a);
    case kinds2(kF32, kBF16): return launch_heads<3, float, bf16_bits>(a);
    case kinds2(kF32, kI8): return launch_heads<3, float, signed char>(a);
    case kinds2(kBF16, kBF16): return launch_heads<3, bf16_bits, bf16_bits>(a);
    case kinds2(kBF16, kI8): return launch_heads<3, bf16_bits, signed char>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
