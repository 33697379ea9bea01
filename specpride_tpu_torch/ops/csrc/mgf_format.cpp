// Peak-line formatter of the port's MGF writer (C ABI, loaded with ctypes
// by ops/_build.py::load_host; io/native.py calls it).
//
// The JAX package's writer (io/mgf.py::format_spectrum) turns each float64
// into text with numpy (astype("U32"): the shortest digits that read back
// to the same double, laid out as Python's repr), one "<mz> <intensity>"
// line per peak.  Through the chunked executor that conversion is most of
// the wall.  Here std::to_chars gives the same shortest round-trip digits
// and repr_double lays them out by repr's rules, so the bytes are those of
// the numpy writer (io/mgf.py::format_spectrum_plain holds them to it):
//   * exponent form when the decimal exponent is < -4 or >= 16, with a
//     sign and at least two exponent digits ("1e-05", "1.5e+16");
//   * otherwise positional, with ".0" on integral values ("100.0");
//   * "-0.0", "inf", "-inf" as repr writes them.
// A pair with NaN in either column is skipped, as the numpy writer does.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Longest line: two 24-byte reprs ("-1.7976931348623157e+308"), a space
// and a newline.
constexpr int64_t kMaxLine = 50;

// Python's repr(x) into out (at least 24 bytes); returns its length.
int repr_double(double x, char* out) {
  char* o = out;
  if (std::isnan(x)) {
    std::memcpy(o, "nan", 3);
    return 3;
  }
  if (std::isinf(x)) {
    if (x < 0) *o++ = '-';
    std::memcpy(o, "inf", 3);
    return static_cast<int>(o - out) + 3;
  }
  char buf[32];
  auto res = std::to_chars(buf, buf + sizeof buf, x,
                           std::chars_format::scientific);
  // buf holds [-]d[.ddd]e(+|-)dd[d]: split it into digits and exponent
  const char* p = buf;
  if (*p == '-') {
    *o++ = '-';
    ++p;
  }
  char digits[24];
  int nd = 0;
  for (; *p != 'e'; ++p) {
    if (*p != '.') digits[nd++] = *p;
  }
  ++p;
  const bool neg_exp = *p == '-';
  ++p;
  int e = 0;
  for (; p < res.ptr; ++p) e = e * 10 + (*p - '0');
  if (neg_exp) e = -e;

  if (e < -4 || e >= 16) {
    *o++ = digits[0];
    if (nd > 1) {
      *o++ = '.';
      std::memcpy(o, digits + 1, nd - 1);
      o += nd - 1;
    }
    *o++ = 'e';
    *o++ = e < 0 ? '-' : '+';
    int ae = std::abs(e);
    if (ae >= 100) {
      *o++ = static_cast<char>('0' + ae / 100);
      ae %= 100;
    }
    *o++ = static_cast<char>('0' + ae / 10);
    *o++ = static_cast<char>('0' + ae % 10);
  } else if (e < 0) {
    *o++ = '0';
    *o++ = '.';
    for (int i = 0; i < -e - 1; ++i) *o++ = '0';
    std::memcpy(o, digits, nd);
    o += nd;
  } else {
    const int before = e + 1;  // digits left of the point
    if (nd <= before) {
      std::memcpy(o, digits, nd);
      o += nd;
      for (int i = nd; i < before; ++i) *o++ = '0';
      *o++ = '.';
      *o++ = '0';
    } else {
      std::memcpy(o, digits, before);
      o += before;
      *o++ = '.';
      std::memcpy(o, digits + before, nd - before);
      o += nd - before;
    }
  }
  return static_cast<int>(o - out);
}

// The lines of pairs [lo, hi) into out, which has room for kMaxLine bytes
// per pair; returns the bytes written.
int64_t format_range(const double* mz, const double* inten, int64_t lo,
                     int64_t hi, char* out) {
  char* o = out;
  for (int64_t i = lo; i < hi; ++i) {
    if (std::isnan(mz[i]) || std::isnan(inten[i])) continue;
    o += repr_double(mz[i], o);
    *o++ = ' ';
    o += repr_double(inten[i], o);
    *o++ = '\n';
  }
  return o - out;
}

}  // namespace

extern "C" {

// "<mz> <intensity>\n" for each of the n pairs without NaN, into out.
// Returns the bytes written, or -1 (and writes nothing past cap) when
// they do not fit in cap bytes.
int64_t mgf_format_peaks(const double* mz, const double* inten, int64_t n,
                         char* out, int64_t cap) {
  char line[kMaxLine];
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len = format_range(mz, inten, i, i + 1, line);
    if (pos + len > cap) return -1;
    std::memcpy(out + pos, line, len);
    pos += len;
  }
  return pos;
}

// The peak lines of n_spectra spectra in one call: spectrum s owns pairs
// [offsets[s], offsets[s+1]); its text lands at
// out[out_offsets[s]:out_offsets[s+1]].  Threads (n_threads <= 0: one per
// hardware thread) format contiguous runs of spectra of about equal peak
// counts into their own buffers, copied into out in order.  Returns the
// total bytes, or -1 (nothing written past cap) when they exceed cap.
int64_t mgf_format_batch(const double* mz, const double* inten,
                         const int64_t* offsets, int64_t n_spectra,
                         char* out, int64_t cap, int64_t* out_offsets,
                         int n_threads) {
  const int64_t n_peaks = n_spectra > 0 ? offsets[n_spectra] : 0;
  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc ? static_cast<int>(hc) : 4;
  }
  // below ~64k pairs a thread costs more than it saves
  const int64_t by_size = std::max<int64_t>(n_peaks >> 16, 1);
  const int64_t n_parts = std::min<int64_t>(
      std::min<int64_t>(n_threads, by_size), std::max<int64_t>(n_spectra, 1));
  // part t formats spectra [first[t], first[t+1])
  std::vector<int64_t> first(n_parts + 1, n_spectra);
  first[0] = 0;
  for (int64_t t = 1; t < n_parts; ++t) {
    first[t] = std::upper_bound(offsets, offsets + n_spectra,
                                n_peaks * t / n_parts) - offsets;
    first[t] = std::max(first[t], first[t - 1]);
  }
  std::vector<std::string> text(n_parts);
  std::vector<int64_t> ends(n_spectra);  // each spectrum's end, part-local
  auto work = [&](int64_t t) {
    const int64_t s0 = first[t], s1 = first[t + 1];
    std::string& buf = text[t];
    buf.resize((offsets[s1] - offsets[s0]) * kMaxLine);
    int64_t pos = 0;
    for (int64_t s = s0; s < s1; ++s) {
      pos += format_range(mz, inten, offsets[s], offsets[s + 1],
                          buf.data() + pos);
      ends[s] = pos;
    }
    buf.resize(pos);
  };
  if (n_parts == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_parts);
    for (int64_t t = 0; t < n_parts; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  int64_t total = 0;
  for (const auto& b : text) total += static_cast<int64_t>(b.size());
  if (total > cap) return -1;
  int64_t base = 0;
  out_offsets[0] = 0;
  for (int64_t t = 0; t < n_parts; ++t) {
    std::memcpy(out + base, text[t].data(), text[t].size());
    for (int64_t s = first[t]; s < first[t + 1]; ++s)
      out_offsets[s + 1] = base + ends[s];
    base += static_cast<int64_t>(text[t].size());
  }
  return total;
}

}  // extern "C"
