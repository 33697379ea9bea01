// MGF (Mascot Generic Format) parser of the port's host library (C ABI,
// loaded with ctypes by ops/_build.py::load_host; io/native.py reads it).
//
// The port's copy of the JAX package's native/mgf_parser.cpp: the same
// entry points and semantics, the same threaded split at record
// boundaries.  One difference: no zlib.  A ".gz" input is decompressed by
// the caller (Python's gzip) and handed over through mgf_parse_buffer, so
// the host library needs no library beyond the C++ runtime and one parser
// serves both inputs.
//
// Semantics mirror the pure-Python parser (io/mgf.py parse_mgf_stream):
//   * lines outside BEGIN IONS / END IONS are ignored; blank lines skipped
//   * a line starting with a digit or '+'/'-'/'.' inside a record is a peak
//     line: first field = m/z, second = intensity (missing -> 0.0)
//   * other record lines are KEY=VALUE headers; KEY is uppercased;
//     TITLE / PEPMASS (first field) / CHARGE (N+, N-, N) / RTINSECONDS are
//     extracted, everything else is kept verbatim as per-spectrum extras
//   * a record yields a spectrum only on END IONS; the peaks of a record
//     that a BEGIN IONS or the end of the input cuts short are dropped
// Numbers are parsed with std::from_chars (correctly rounded, as Python's
// float()), so both parsers give the same float64 bit patterns.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Columns {
  std::vector<double> mz;
  std::vector<double> intensity;
  std::vector<int64_t> peak_offsets;  // n_spectra + 1
  std::vector<double> precursor_mz;
  std::vector<int32_t> charge;
  std::vector<double> rt;
  std::string titles;                  // concatenated
  std::vector<int64_t> title_offsets;  // n_spectra + 1
  std::string extras;                  // "KEY=VALUE\n..." per spectrum
  std::vector<int64_t> extra_offsets;  // n_spectra + 1
};

struct MgfFile {
  Columns c;
  std::string error;
};

bool read_whole_file(const char* path, std::string& out, std::string& err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    err = std::string("cannot open ") + path;
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    err = "ftell failed";
    return false;
  }
  out.resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(out.data(), 1, out.size(), f) : 0;
  std::fclose(f);
  if (got != out.size()) {
    err = "short read";
    return false;
  }
  return true;
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* trim_end(const char* p, const char* end) {
  while (end > p &&
         (end[-1] == ' ' || end[-1] == '\t' || end[-1] == '\r')) --end;
  return end;
}

inline bool is_field_ws(char c) { return c == ' ' || c == '\t'; }

// Parse ONE whole whitespace-delimited field as a double.  Python's
// float(field) raises on any trailing junk within the field and accepts a
// leading '+' (which std::from_chars does not) — mirror both: after the
// numeric parse the field must be exhausted (next char is whitespace or
// line end).  from_chars consumes the maximal valid prefix, so a single
// trailing-char check is equivalent to pre-scanning the field boundary —
// and one pass cheaper.  Returns pointer past the field, or nullptr.
inline const char* parse_double_field(const char* p, const char* end,
                                      double& out) {
  if (p < end && *p == '+') ++p;
  auto [ptr, ec] = std::from_chars(p, end, out);
  if (ec != std::errc()) return nullptr;
  if (ptr < end && !is_field_ws(*ptr)) return nullptr;  // junk inside field
  return ptr;
}

// CHARGE=2+ / 2- / 2 / +2  ->  signed int (mirror of mgf.py _parse_charge:
// strip ALL trailing '+' or ALL trailing '-', then int() the rest — which
// accepts a leading sign but no other junk).  Returns false on values where
// Python's int() would raise.
bool parse_charge(const char* p, const char* end, int32_t& out) {
  p = skip_ws(p, end);
  end = trim_end(p, end);
  int sign = 1;
  if (end > p && end[-1] == '+') {
    while (end > p && end[-1] == '+') --end;
  } else if (end > p && end[-1] == '-') {
    while (end > p && end[-1] == '-') --end;
    sign = -1;
  }
  if (end <= p) {
    out = 0;  // bare "+"/"-" strips to empty -> 0, as the Python parser
    return true;
  }
  if (*p == '+') ++p;  // from_chars<int> rejects the leading '+' int() allows
  int value = 0;
  auto [ptr, ec] = std::from_chars(p, end, value);
  if (ec != std::errc() || ptr != end) return false;
  out = sign * value;
  return true;
}

// The peaks read since the last finished record belong to no spectrum.
void discard_open_peaks(Columns& c) {
  size_t done = static_cast<size_t>(c.peak_offsets.back());
  c.mz.resize(done);
  c.intensity.resize(done);
}

bool parse_range(const char* p, const char* file_end, int64_t line_base,
                 Columns& c, std::string& err) {
  // reserve from a size heuristic (~18 bytes per peak line) to avoid
  // vector regrowth memcpys on large files
  size_t approx_peaks = static_cast<size_t>(file_end - p) / 18 + 16;
  c.mz.reserve(approx_peaks);
  c.intensity.reserve(approx_peaks);

  bool in_ions = false;
  std::string title, extras_cur;
  double pepmass = 0.0, rtsec = 0.0;
  int32_t z = 0;
  int64_t line_no = line_base;

  c.peak_offsets.push_back(0);
  c.title_offsets.push_back(0);
  c.extra_offsets.push_back(0);

  while (p < file_end) {
    ++line_no;
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(file_end - p)));
    const char* line_end = nl ? nl : file_end;
    const char* s = skip_ws(p, line_end);
    const char* e = trim_end(s, line_end);
    p = nl ? nl + 1 : file_end;
    if (s == e) continue;  // blank
    size_t len = static_cast<size_t>(e - s);

    if (len == 10 && std::memcmp(s, "BEGIN IONS", 10) == 0) {
      in_ions = true;
      title.clear();
      extras_cur.clear();
      pepmass = 0.0;
      rtsec = 0.0;
      z = 0;
      // drop the peaks of a record left open (truncated: no END IONS), as
      // the Python parser does, or they would open this record's peaks
      discard_open_peaks(c);
      continue;
    }
    if (len == 8 && std::memcmp(s, "END IONS", 8) == 0) {
      if (in_ions) {
        c.peak_offsets.push_back(static_cast<int64_t>(c.mz.size()));
        c.precursor_mz.push_back(pepmass);
        c.charge.push_back(z);
        c.rt.push_back(rtsec);
        c.titles.append(title);
        c.title_offsets.push_back(static_cast<int64_t>(c.titles.size()));
        c.extras.append(extras_cur);
        c.extra_offsets.push_back(static_cast<int64_t>(c.extras.size()));
      }
      in_ions = false;
      continue;
    }
    if (!in_ions) continue;

    char first = *s;
    if ((first >= '0' && first <= '9') || first == '+' || first == '-' ||
        first == '.') {
      // Python: fields = line.split(); float(fields[0]), float(fields[1])
      // — first two fields must each be fully-valid floats (raise
      // otherwise); any further fields are ignored.
      double mz_val = 0.0;
      const char* q = parse_double_field(s, e, mz_val);
      if (!q) {
        char buf[96];
        std::snprintf(buf, sizeof buf, "line %lld: bad peak m/z",
                      static_cast<long long>(line_no));
        err = buf;
        return false;
      }
      double inten_val = 0.0;
      q = skip_ws(q, e);
      if (q < e) {
        if (!parse_double_field(q, e, inten_val)) {
          char buf[96];
          std::snprintf(buf, sizeof buf, "line %lld: bad peak intensity",
                        static_cast<long long>(line_no));
          err = buf;
          return false;
        }
      }
      c.mz.push_back(mz_val);
      c.intensity.push_back(inten_val);
      continue;
    }

    const char* eq = static_cast<const char*>(
        std::memchr(s, '=', static_cast<size_t>(e - s)));
    if (!eq) continue;  // mirror Python: non-KEY=VALUE line ignored
    const char* key_end = trim_end(s, eq);
    std::string key(s, static_cast<size_t>(key_end - s));
    for (char& ch : key)
      ch = static_cast<char>(std::toupper(static_cast<unsigned char>(ch)));
    const char* v = skip_ws(eq + 1, e);

    if (key == "TITLE") {
      title.assign(v, static_cast<size_t>(e - v));
    } else if (key == "PEPMASS") {
      // first whitespace-separated field only; empty value -> 0.0, junk ->
      // error (Python float(value.split()[0]) raises)
      if (v < e && !parse_double_field(v, e, pepmass)) {
        char buf[96];
        std::snprintf(buf, sizeof buf, "line %lld: bad PEPMASS",
                      static_cast<long long>(line_no));
        err = buf;
        return false;
      }
    } else if (key == "CHARGE") {
      if (!parse_charge(v, e, z)) {
        char buf[96];
        std::snprintf(buf, sizeof buf, "line %lld: bad CHARGE",
                      static_cast<long long>(line_no));
        err = buf;
        return false;
      }
    } else if (key == "RTINSECONDS") {
      // Python float(value or 0.0): whole (stripped) value must parse;
      // empty -> 0.0
      const char* fe = (v < e && *v == '+') ? v + 1 : v;
      double val = 0.0;
      if (v < e) {
        auto [ptr, ec] = std::from_chars(fe, e, val);
        if (ec != std::errc() || ptr != e) {
          char buf[96];
          std::snprintf(buf, sizeof buf, "line %lld: bad RTINSECONDS",
                        static_cast<long long>(line_no));
          err = buf;
          return false;
        }
        rtsec = val;
      }
    } else {
      extras_cur.append(key);
      extras_cur.push_back('=');
      extras_cur.append(v, static_cast<size_t>(e - v));
      extras_cur.push_back('\n');
    }
  }
  discard_open_peaks(c);  // a record still open at the end
  return true;
}

void merge_columns(Columns& dst, Columns& src) {
  int64_t peak_base = static_cast<int64_t>(dst.mz.size());
  int64_t title_base = static_cast<int64_t>(dst.titles.size());
  int64_t extra_base = static_cast<int64_t>(dst.extras.size());
  dst.mz.insert(dst.mz.end(), src.mz.begin(), src.mz.end());
  dst.intensity.insert(dst.intensity.end(), src.intensity.begin(),
                       src.intensity.end());
  dst.precursor_mz.insert(dst.precursor_mz.end(), src.precursor_mz.begin(),
                          src.precursor_mz.end());
  dst.charge.insert(dst.charge.end(), src.charge.begin(), src.charge.end());
  dst.rt.insert(dst.rt.end(), src.rt.begin(), src.rt.end());
  dst.titles.append(src.titles);
  dst.extras.append(src.extras);
  // offset vectors all start with 0 — skip it and rebase
  for (size_t i = 1; i < src.peak_offsets.size(); ++i)
    dst.peak_offsets.push_back(src.peak_offsets[i] + peak_base);
  for (size_t i = 1; i < src.title_offsets.size(); ++i)
    dst.title_offsets.push_back(src.title_offsets[i] + title_base);
  for (size_t i = 1; i < src.extra_offsets.size(); ++i)
    dst.extra_offsets.push_back(src.extra_offsets[i] + extra_base);
}

// Split the buffer at record boundaries ("BEGIN IONS" at start of line) and
// parse the chunks in parallel.  Records are independent, so per-chunk
// Columns concatenate into exactly the single-thread result.
bool parse_buffer(const char* base, size_t size, int n_threads, Columns& c,
                  std::string& err) {
  const char* end = base + size;

  // n_threads <= 0: one per hardware thread (tests pass 2 to force the
  // split on a small host)
  size_t want = static_cast<size_t>(n_threads);
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    want = hw ? hw : 1;
  }
  if (want > 16) want = 16;
  const size_t min_chunk = 4 << 20;  // below ~4 MB threads don't pay
  if (size / min_chunk < want) want = size / min_chunk;
  if (want <= 1) return parse_range(base, end, 0, c, err);

  std::vector<const char*> starts{base};
  for (size_t t = 1; t < want; ++t) {
    const char* guess = base + size * t / want;
    // advance to the next line that begins "BEGIN IONS"
    const char* q = guess;
    const char* found = nullptr;
    while (q < end) {
      const char* nl = static_cast<const char*>(
          std::memchr(q, '\n', static_cast<size_t>(end - q)));
      if (!nl) break;
      q = nl + 1;
      if (static_cast<size_t>(end - q) >= 10 &&
          std::memcmp(q, "BEGIN IONS", 10) == 0) {
        // the serial parser only treats a line *trimming to exactly*
        // "BEGIN IONS" as a record start; accepting e.g. "BEGIN IONSX"
        // or "BEGIN IONS extra" as a split point would silently drop the
        // enclosing record on multithreaded parses.  A missed split point
        // is harmless (the previous chunk parses through it), so be
        // strict: rest of the line must be whitespace only.
        const char* r = q + 10;
        while (r < end && (*r == ' ' || *r == '\t' || *r == '\r')) ++r;
        if (r == end || *r == '\n') {
          found = q;
          break;
        }
      }
    }
    if (found && found > starts.back()) starts.push_back(found);
  }
  starts.push_back(end);

  size_t n_chunks = starts.size() - 1;
  // absolute starting line number per chunk, so parse errors cite real
  // file lines regardless of which thread hits them
  std::vector<int64_t> line_bases(n_chunks, 0);
  for (size_t i = 1; i < n_chunks; ++i) {
    int64_t count = 0;
    for (const char* q = starts[i - 1]; q < starts[i]; ++q)
      if (*q == '\n') ++count;
    line_bases[i] = line_bases[i - 1] + count;
  }
  std::vector<Columns> cols(n_chunks);
  std::vector<std::string> errs(n_chunks);
  std::vector<char> oks(n_chunks, 0);
  std::vector<std::thread> threads;
  for (size_t i = 0; i < n_chunks; ++i) {
    threads.emplace_back([&, i] {
      try {
        oks[i] = parse_range(starts[i], starts[i + 1], line_bases[i], cols[i],
                             errs[i])
                     ? 1
                     : 0;
      } catch (const std::exception& e) {
        errs[i] = e.what();  // rethrowing would std::terminate the process
      } catch (...) {
        errs[i] = "unknown C++ exception";
      }
    });
  }
  for (auto& th : threads) th.join();
  for (size_t i = 0; i < n_chunks; ++i) {
    if (!oks[i]) {
      err = errs[i];
      return false;
    }
  }

  // the merged columns at their exact sizes, so each chunk is copied once,
  // and each chunk freed once it is in
  size_t peaks = 0, spectra = 0, titles = 0, extras = 0;
  for (const auto& chunk : cols) {
    peaks += chunk.mz.size();
    spectra += chunk.precursor_mz.size();
    titles += chunk.titles.size();
    extras += chunk.extras.size();
  }
  c.mz.reserve(peaks);
  c.intensity.reserve(peaks);
  c.precursor_mz.reserve(spectra);
  c.charge.reserve(spectra);
  c.rt.reserve(spectra);
  c.titles.reserve(titles);
  c.extras.reserve(extras);
  for (auto* offsets : {&c.peak_offsets, &c.title_offsets, &c.extra_offsets}) {
    offsets->reserve(spectra + 1);
    offsets->push_back(0);
  }
  for (auto& chunk : cols) {
    merge_columns(c, chunk);
    chunk = Columns();
  }
  return true;
}

// Runs parse(f) and hands back f, or nullptr with the error in errbuf.
// Exceptions must not cross the C ABI into the ctypes frame
// (std::terminate would abort the whole Python process): catch
// everything, including bad_alloc from oversized inputs.
template <typename Parse>
MgfFile* guarded(Parse parse, char* errbuf, int errlen) {
  MgfFile* f = nullptr;
  try {
    f = new MgfFile();
    if (parse(f)) return f;
  } catch (const std::exception& e) {
    if (f)
      f->error = e.what();
    else if (errbuf && errlen > 0)
      std::snprintf(errbuf, static_cast<size_t>(errlen), "%s", e.what());
  } catch (...) {
    if (f) f->error = "unknown C++ exception";
  }
  if (f) {
    if (errbuf && errlen > 0) {
      std::snprintf(errbuf, static_cast<size_t>(errlen), "%s",
                    f->error.c_str());
    }
    delete f;
  }
  return nullptr;
}


// ---- the byte index of a streamed input (io/mgf.py::StreamedClusters) ----
//
// One pass over the file, split over threads at "BEGIN IONS" lines as
// parse_buffer splits, each thread reading its byte range in blocks with
// pread; the ranges' records concatenate in file order.  Mirrors the Python
// scan line for line (io/mgf.py::StreamedClusters._scan_plain, the JAX
// package's _scan):
//   * lines end at '\n' (kept in the line's length); a line is compared
//     after bytes.strip(), which drops ' ', '\t', '\n', '\r', '\v', '\f'
//     at both ends;
//   * "BEGIN IONS" opens a record at the line's offset; one that opens
//     while a record is open closes the open one as a truncated span
//     [its begin, this line's offset);
//   * a stripped line starting "TITLE=" sets the title (the last one
//     wins; a BEGIN clears it);
//   * "END IONS" inside a record ends it at the offset past its line;
//   * a record still open at EOF is a truncated span [begin, EOF).
// A range starts at a line the serial scan reads as BEGIN IONS, which
// resets its state, so each range scans as the serial pass would; a record
// open at a range's end is the truncated span the serial pass closes at
// the next range's first line.
//
// Then the records are grouped into clusters (group_records), as
// io/mgf.py's grouping by data/peaks.py::parse_title did: a record's
// cluster id is its title up to the first ';' (all of it without one), or
// "index=N" without a title, N its place among the records; clusters in
// the order their ids first appear, each one's records in file order.
// Titles are handed back as raw bytes with the first one that is not UTF-8
// (the caller decodes that one, which raises as the Python scan does).

// The scan threads take their memory straight from mmap, so a thread that
// never calls malloc is never handed a malloc arena.  Short-lived threads
// that malloc at each job's start take arenas off glibc's free list, and the
// lanes that run next then land on other arenas, each of which went on to
// hold tens of MB of their freed memory: the process's peak RSS rose job by
// job.
template <typename T>
struct PageAllocator {
  using value_type = T;
  PageAllocator() = default;
  template <typename U>
  PageAllocator(const PageAllocator<U>&) {}
  T* allocate(size_t n) {
    void* p = mmap(nullptr, n * sizeof(T), PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) throw std::bad_alloc();
    return static_cast<T*>(p);
  }
  void deallocate(T* p, size_t n) { munmap(p, n * sizeof(T)); }
};
template <typename T, typename U>
bool operator==(const PageAllocator<T>&, const PageAllocator<U>&) {
  return true;
}
template <typename T, typename U>
bool operator!=(const PageAllocator<T>&, const PageAllocator<U>&) {
  return false;
}
template <typename T>
using PageVector = std::vector<T, PageAllocator<T>>;
using PageString =
    std::basic_string<char, std::char_traits<char>, PageAllocator<char>>;

// One scan thread's records, in file order.
struct RangeIndex {
  PageVector<int64_t> begin, end;
  PageVector<uint8_t> has_title;
  PageString titles;
  PageVector<int64_t> title_offsets;
  PageVector<int64_t> span_begin, span_end;
};

struct MgfIndex {
  // the records, in file order
  std::vector<int64_t> begin, end;
  std::vector<uint8_t> has_title;
  std::string titles;
  std::vector<int64_t> title_offsets{0};
  std::vector<int64_t> span_begin, span_end;
  int64_t bad_title = -1;  // the first record whose title is not UTF-8
  // the clusters: names (concatenated) and each one's records, CSR
  std::string names;
  std::vector<int64_t> name_offsets{0};
  std::vector<int64_t> group_offsets{0};
  std::vector<int64_t> member_begin, member_end;
  std::string error;
};

inline bool py_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

inline void py_strip(const char*& s, const char*& e) {
  while (s < e && py_space(*s)) ++s;
  while (e > s && py_space(e[-1])) --e;
}

inline bool is_begin_line(const char* p, size_t len) {
  const char* s = p;
  const char* e = p + len;
  py_strip(s, e);
  return e - s == 10 && std::memcmp(s, "BEGIN IONS", 10) == 0;
}

struct IndexScan {
  RangeIndex& x;
  int64_t begin = -1;
  bool has_title = false;
  PageString title;

  void line(const char* p, size_t len, int64_t offset) {
    const char* s = p;
    const char* e = p + len;
    py_strip(s, e);
    size_t n = static_cast<size_t>(e - s);
    if (n == 10 && std::memcmp(s, "BEGIN IONS", 10) == 0) {
      if (begin >= 0) {
        x.span_begin.push_back(begin);
        x.span_end.push_back(offset);
      }
      begin = offset;
      has_title = false;
      title.clear();
    } else if (n >= 6 && std::memcmp(s, "TITLE=", 6) == 0) {
      title.assign(s + 6, n - 6);
      has_title = true;
    } else if (n == 8 && std::memcmp(s, "END IONS", 8) == 0 && begin >= 0) {
      x.begin.push_back(begin);
      x.end.push_back(offset + static_cast<int64_t>(len));
      x.has_title.push_back(has_title ? 1 : 0);
      if (has_title) x.titles.append(title);
      x.title_offsets.push_back(static_cast<int64_t>(x.titles.size()));
      begin = -1;
    }
  }
};

// Calls fn(line, len, offset) for each line of the file's bytes [lo, hi),
// in order, the first starting at lo, each with its '\n' (the last one may
// have none), read in blocks of buf's size; a line that crosses a block's
// end is carried over.  fn returns false to stop.  Returns the offset past
// the last line read, or -1 on a read error.
template <typename Fn>
int64_t for_each_line(int fd, int64_t lo, int64_t hi, PageVector<char>& buf,
                      Fn&& fn) {
  PageString carry;
  int64_t offset = lo;  // the file offset of the next line's first byte
  int64_t pos = lo;     // the file offset of the next block
  while (pos < hi) {
    size_t want = static_cast<size_t>(
        std::min<int64_t>(static_cast<int64_t>(buf.size()), hi - pos));
    ssize_t got = pread(fd, buf.data(), want, pos);
    if (got < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (got == 0) break;  // the file is shorter than its size said
    pos += got;
    const char* p = buf.data();
    const char* end = p + got;
    while (p < end) {
      const char* nl = static_cast<const char*>(
          std::memchr(p, '\n', static_cast<size_t>(end - p)));
      if (!nl) {
        carry.append(p, static_cast<size_t>(end - p));
        break;
      }
      size_t len = static_cast<size_t>(nl + 1 - p);
      bool go;
      if (carry.empty()) {
        go = fn(p, len, offset);
        offset += static_cast<int64_t>(len);
      } else {
        carry.append(p, len);
        go = fn(carry.data(), carry.size(), offset);
        offset += static_cast<int64_t>(carry.size());
        carry.clear();
      }
      if (!go) return offset;
      p = nl + 1;
    }
  }
  if (!carry.empty()) {  // a last line without '\n'
    fn(carry.data(), carry.size(), offset);
    offset += static_cast<int64_t>(carry.size());
  }
  return offset;
}

// The offset of the first BEGIN IONS line after the line that holds byte
// `guess`, or -1 (none, or a read error: the range before runs on).
int64_t next_record_start(int fd, int64_t guess, int64_t size) {
  PageVector<char> buf(64 << 10);
  int64_t found = -1;
  bool first = true;
  for_each_line(fd, guess, size, buf,
                [&](const char* p, size_t len, int64_t offset) {
                  if (first) {  // the line guess falls in (or starts)
                    first = false;
                    return true;
                  }
                  if (!is_begin_line(p, len)) return true;
                  found = offset;
                  return false;
                });
  return found;
}

// Python's strict UTF-8 (no overlongs, no surrogates, nothing past
// U+10FFFF): the titles bytes.decode("utf-8") accepts.
bool valid_utf8(const unsigned char* s, size_t n) {
  size_t i = 0;
  while (i < n) {
    unsigned char c = s[i];
    if (c < 0x80) {
      ++i;
      continue;
    }
    size_t len;
    unsigned char lo = 0x80, hi = 0xBF;  // the range of the second byte
    if (c >= 0xC2 && c <= 0xDF) {
      len = 2;
    } else if (c >= 0xE0 && c <= 0xEF) {
      len = 3;
      if (c == 0xE0) lo = 0xA0;
      if (c == 0xED) hi = 0x9F;
    } else if (c >= 0xF0 && c <= 0xF4) {
      len = 4;
      if (c == 0xF0) lo = 0x90;
      if (c == 0xF4) hi = 0x8F;
    } else {
      return false;
    }
    if (n - i < len || s[i + 1] < lo || s[i + 1] > hi) return false;
    for (size_t k = 2; k < len; ++k)
      if (s[i + k] < 0x80 || s[i + k] > 0xBF) return false;
    i += len;
  }
  return true;
}

void group_records(MgfIndex& x) {
  size_t n = x.begin.size();
  // every record's cluster id, concatenated
  std::string keys;
  keys.reserve(x.titles.size() + 16 * n);
  std::vector<size_t> key_offsets(n + 1, 0);
  for (size_t i = 0; i < n; ++i) {
    if (x.has_title[i]) {
      const char* t = x.titles.data() + x.title_offsets[i];
      size_t len = static_cast<size_t>(x.title_offsets[i + 1] -
                                       x.title_offsets[i]);
      if (x.bad_title < 0 &&
          !valid_utf8(reinterpret_cast<const unsigned char*>(t), len))
        x.bad_title = static_cast<int64_t>(i);
      const char* semi = static_cast<const char*>(std::memchr(t, ';', len));
      keys.append(t, semi ? static_cast<size_t>(semi - t) : len);
    } else {
      keys.append("index=");
      keys.append(std::to_string(i));
    }
    key_offsets[i + 1] = keys.size();
  }
  std::unordered_map<std::string_view, int64_t> code_of;
  code_of.reserve(n);
  std::vector<int64_t> code(n);
  for (size_t i = 0; i < n; ++i) {
    std::string_view key(keys.data() + key_offsets[i],
                         key_offsets[i + 1] - key_offsets[i]);
    auto [it, fresh] = code_of.emplace(
        key, static_cast<int64_t>(x.name_offsets.size() - 1));
    if (fresh) {
      x.names.append(key);
      x.name_offsets.push_back(static_cast<int64_t>(x.names.size()));
    }
    code[i] = it->second;
  }
  size_t n_clusters = x.name_offsets.size() - 1;
  x.group_offsets.assign(n_clusters + 1, 0);
  for (size_t i = 0; i < n; ++i) ++x.group_offsets[code[i] + 1];
  for (size_t g = 0; g < n_clusters; ++g)
    x.group_offsets[g + 1] += x.group_offsets[g];
  std::vector<int64_t> cursor(x.group_offsets.begin(),
                              x.group_offsets.end() - 1);
  x.member_begin.resize(n);
  x.member_end.resize(n);
  for (size_t i = 0; i < n; ++i) {
    int64_t slot = cursor[code[i]]++;
    x.member_begin[slot] = x.begin[i];
    x.member_end[slot] = x.end[i];
  }
}

void append_index(MgfIndex& dst, const RangeIndex& src) {
  int64_t title_base = static_cast<int64_t>(dst.titles.size());
  dst.begin.insert(dst.begin.end(), src.begin.begin(), src.begin.end());
  dst.end.insert(dst.end.end(), src.end.begin(), src.end.end());
  dst.has_title.insert(dst.has_title.end(), src.has_title.begin(),
                       src.has_title.end());
  dst.titles.append(src.titles.data(), src.titles.size());
  for (int64_t off : src.title_offsets)
    dst.title_offsets.push_back(off + title_base);
  dst.span_begin.insert(dst.span_begin.end(), src.span_begin.begin(),
                        src.span_begin.end());
  dst.span_end.insert(dst.span_end.end(), src.span_end.begin(),
                      src.span_end.end());
}

// Scan threads by default: on an 8-core H100 host a 389 MB memory file
// indexed in 0.26 s on one thread, 0.13-0.15 s on four and 0.17-0.18 s on
// eight, whose reads out of the page cache contend in the kernel (system
// time 0.07, 0.19-0.26 and 0.70-0.75 s).
constexpr int64_t kIndexThreads = 4;

// n_threads <= 0: up to kIndexThreads, each range at least 8 MB (tests pass
// a count to force the split on a small file).
bool index_file(const char* path, int n_threads, MgfIndex& x,
                std::string& err) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) {
    err = std::string("cannot open ") + path;
    return false;
  }
  struct Closer {
    int fd;
    ~Closer() { close(fd); }
  } closer{fd};
  struct stat st;
  if (fstat(fd, &st) != 0) {
    err = std::string("cannot stat ") + path;
    return false;
  }
  int64_t size = static_cast<int64_t>(st.st_size);
  int64_t want = n_threads;
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    want = std::min<int64_t>(std::min<int64_t>(hw ? hw : 1, kIndexThreads),
                             size / (8 << 20));
  }
  want = std::max<int64_t>(1, std::min<int64_t>(want, 16));
  std::vector<int64_t> starts{0};
  for (int64_t t = 1; t < want; ++t) {
    int64_t s = next_record_start(fd, size * t / want, size);
    if (s > starts.back()) starts.push_back(s);
  }
  starts.push_back(size);
  size_t n_ranges = starts.size() - 1;
  std::vector<RangeIndex> parts(n_ranges);
  std::vector<char> oks(n_ranges, 0);
  auto scan_range = [&](size_t i) {
    IndexScan scan{parts[i]};
    PageVector<char> buf(2 << 20);
    int64_t reached = for_each_line(
        fd, starts[i], starts[i + 1], buf,
        [&](const char* p, size_t len, int64_t offset) {
          scan.line(p, len, offset);
          return true;
        });
    if (reached < 0) return;
    if (scan.begin >= 0) {
      parts[i].span_begin.push_back(scan.begin);
      parts[i].span_end.push_back(reached);
    }
    oks[i] = 1;
  };
  if (n_ranges == 1) {
    scan_range(0);
  } else {
    std::vector<std::thread> threads;
    for (size_t i = 0; i < n_ranges; ++i)
      threads.emplace_back([&, i] {
        try {
          scan_range(i);
        } catch (...) {  // rethrowing would std::terminate the process
        }
      });
    for (auto& th : threads) th.join();
  }
  for (size_t i = 0; i < n_ranges; ++i) {
    if (!oks[i]) {
      err = std::string("read error on ") + path;
      return false;
    }
    append_index(x, parts[i]);
  }
  group_records(x);
  return true;
}

}  // namespace

extern "C" {

// Parse the MGF file at path (plain text; see mgf_parse_buffer for gzip),
// one thread per hardware thread.
MgfFile* mgf_parse(const char* path, char* errbuf, int errlen) {
  return guarded(
      [&](MgfFile* f) {
        std::string text;
        return read_whole_file(path, text, f->error) &&
               parse_buffer(text.data(), text.size(), 0, f->c, f->error);
      },
      errbuf, errlen);
}

// Parse n bytes of MGF text at buf (the caller keeps them alive for the
// call); threads <= 0 means one per hardware thread.
MgfFile* mgf_parse_buffer(const char* buf, int64_t n, int threads,
                          char* errbuf, int errlen) {
  return guarded(
      [&](MgfFile* f) {
        return parse_buffer(buf, static_cast<size_t>(n), threads, f->c,
                            f->error);
      },
      errbuf, errlen);
}

int64_t mgf_n_spectra(const MgfFile* f) {
  return static_cast<int64_t>(f->c.precursor_mz.size());
}
int64_t mgf_n_peaks(const MgfFile* f) {
  return static_cast<int64_t>(f->c.mz.size());
}
const double* mgf_mz(const MgfFile* f) { return f->c.mz.data(); }
const double* mgf_intensity(const MgfFile* f) { return f->c.intensity.data(); }
const int64_t* mgf_peak_offsets(const MgfFile* f) {
  return f->c.peak_offsets.data();
}
const double* mgf_precursor_mz(const MgfFile* f) {
  return f->c.precursor_mz.data();
}
const int32_t* mgf_charge(const MgfFile* f) { return f->c.charge.data(); }
const double* mgf_rt(const MgfFile* f) { return f->c.rt.data(); }
const char* mgf_titles(const MgfFile* f) { return f->c.titles.data(); }
const int64_t* mgf_title_offsets(const MgfFile* f) {
  return f->c.title_offsets.data();
}
const char* mgf_extras(const MgfFile* f) { return f->c.extras.data(); }
const int64_t* mgf_extra_offsets(const MgfFile* f) {
  return f->c.extra_offsets.data();
}
void mgf_free(MgfFile* f) { delete f; }

// The byte index of the MGF file at path and its clusters (see index_file;
// threads <= 0: one per hardware thread), or nullptr with the error in
// errbuf.
MgfIndex* mgf_index(const char* path, int threads, char* errbuf,
                    int errlen) {
  MgfIndex* x = nullptr;
  try {
    x = new MgfIndex();
    if (index_file(path, threads, *x, x->error)) return x;
    if (errbuf && errlen > 0)
      std::snprintf(errbuf, static_cast<size_t>(errlen), "%s",
                    x->error.c_str());
  } catch (const std::exception& e) {
    if (errbuf && errlen > 0)
      std::snprintf(errbuf, static_cast<size_t>(errlen), "%s", e.what());
  } catch (...) {
    if (errbuf && errlen > 0)
      std::snprintf(errbuf, static_cast<size_t>(errlen), "unknown error");
  }
  delete x;
  return nullptr;
}
int64_t mgf_index_n_records(const MgfIndex* x) {
  return static_cast<int64_t>(x->begin.size());
}
const int64_t* mgf_index_begin(const MgfIndex* x) { return x->begin.data(); }
const int64_t* mgf_index_end(const MgfIndex* x) { return x->end.data(); }
const uint8_t* mgf_index_has_title(const MgfIndex* x) {
  return x->has_title.data();
}
const char* mgf_index_titles(const MgfIndex* x) { return x->titles.data(); }
const int64_t* mgf_index_title_offsets(const MgfIndex* x) {
  return x->title_offsets.data();
}
int64_t mgf_index_n_spans(const MgfIndex* x) {
  return static_cast<int64_t>(x->span_begin.size());
}
const int64_t* mgf_index_span_begin(const MgfIndex* x) {
  return x->span_begin.data();
}
const int64_t* mgf_index_span_end(const MgfIndex* x) {
  return x->span_end.data();
}
int64_t mgf_index_bad_title(const MgfIndex* x) { return x->bad_title; }
int64_t mgf_index_n_clusters(const MgfIndex* x) {
  return static_cast<int64_t>(x->name_offsets.size() - 1);
}
const char* mgf_index_names(const MgfIndex* x) { return x->names.data(); }
const int64_t* mgf_index_name_offsets(const MgfIndex* x) {
  return x->name_offsets.data();
}
const int64_t* mgf_index_group_offsets(const MgfIndex* x) {
  return x->group_offsets.data();
}
const int64_t* mgf_index_member_begin(const MgfIndex* x) {
  return x->member_begin.data();
}
const int64_t* mgf_index_member_end(const MgfIndex* x) {
  return x->member_end.data();
}
void mgf_index_free(MgfIndex* x) { delete x; }

}  // extern "C"
