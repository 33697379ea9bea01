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

#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
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

  c.peak_offsets.push_back(0);
  c.title_offsets.push_back(0);
  c.extra_offsets.push_back(0);
  for (auto& chunk : cols) merge_columns(c, chunk);
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
// One pass over the file in blocks, never holding more than a block and
// the line that crosses its end.  Mirrors the Python scan line for line
// (io/mgf.py::StreamedClusters._scan_plain, the JAX package's _scan):
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
// Titles are handed back as raw bytes: the caller decodes them as UTF-8
// and names a record without a title "index=N".

struct MgfIndex {
  std::vector<int64_t> begin, end;
  std::vector<uint8_t> has_title;
  std::string titles;
  std::vector<int64_t> title_offsets{0};
  std::vector<int64_t> span_begin, span_end;
  std::string error;
};

inline bool py_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

struct IndexScan {
  MgfIndex& x;
  int64_t begin = -1;
  bool has_title = false;
  std::string title;

  void line(const char* p, size_t len, int64_t offset) {
    const char* s = p;
    const char* e = p + len;
    while (s < e && py_space(*s)) ++s;
    while (e > s && py_space(e[-1])) --e;
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

bool index_file(const char* path, MgfIndex& x, std::string& err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    err = std::string("cannot open ") + path;
    return false;
  }
  IndexScan scan{x};
  std::vector<char> buf(16 << 20);
  std::string carry;  // the start of a line that crosses a block's end
  int64_t offset = 0;  // the file offset of the next line's first byte
  size_t got;
  while ((got = std::fread(buf.data(), 1, buf.size(), f)) > 0) {
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
      if (carry.empty()) {
        scan.line(p, len, offset);
        offset += static_cast<int64_t>(len);
      } else {
        carry.append(p, len);
        scan.line(carry.data(), carry.size(), offset);
        offset += static_cast<int64_t>(carry.size());
        carry.clear();
      }
      p = nl + 1;
    }
  }
  bool read_error = std::ferror(f) != 0;
  std::fclose(f);
  if (read_error) {
    err = std::string("read error on ") + path;
    return false;
  }
  if (!carry.empty()) {  // a last line without '\n'
    scan.line(carry.data(), carry.size(), offset);
    offset += static_cast<int64_t>(carry.size());
  }
  if (scan.begin >= 0) {
    x.span_begin.push_back(scan.begin);
    x.span_end.push_back(offset);
  }
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

// The byte index of the MGF file at path (see index_file), or nullptr
// with the error in errbuf.
MgfIndex* mgf_index(const char* path, char* errbuf, int errlen) {
  MgfIndex* x = nullptr;
  try {
    x = new MgfIndex();
    if (index_file(path, *x, x->error)) return x;
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
void mgf_index_free(MgfIndex* x) { delete x; }

}  // extern "C"
