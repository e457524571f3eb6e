// Native LIBSVM parser/writer: mmap ingest + multi-threaded parse.
//
// Native equivalent of the reference's native IO layer:
//   - include/plssvm/detail/io/file_reader.hpp:42-206 (mmap-based file
//     ingest split into comment-stripped lines)
//   - include/plssvm/detail/io/libsvm_parsing.hpp:117-221 (OpenMP-parallel
//     sparse "label idx:val" parsing with strict 1-based strictly-increasing
//     index validation), 243-300 (sparse writer, {:.10e} formatting)
//
// Error messages match plssvm_tpu_torch/io/libsvm.py verbatim so the Python
// fallback and this fast path are interchangeable (the tests assert this).
//
// Design: two parses over the mmap'd bytes instead of materializing
// (row, idx, val) triplets — pass 1 validates and finds the feature count,
// pass 2 fills the dense row-major output; both passes are parallel over
// line ranges with std::thread.  Memory overhead beyond the output matrix is
// O(#lines).

#include <algorithm>
#include <atomic>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Line {
    const char* begin;
    const char* end;
};

inline bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' || c == '\f';
}

// mirrors io/libsvm.py _has_label / reference libsvm_parsing.hpp:150-156:
// the row has a label iff the first ':' does not come before the first ' '
bool has_label(const Line& ln) {
    const char* space = static_cast<const char*>(
        memchr(ln.begin, ' ', static_cast<size_t>(ln.end - ln.begin)));
    const char* colon = static_cast<const char*>(
        memchr(ln.begin, ':', static_cast<size_t>(ln.end - ln.begin)));
    if (colon == nullptr) return true;   // no features at all -> whole line is a label
    if (space == nullptr) return false;  // single 'idx:val' token without label
    return colon > space;
}

// Python-compatible numeric parsing: int()/float() accept a leading '+'
bool parse_index(const char* b, const char* e, long long* out) {
    // one optional '+', then ASCII digits, as the Python parser's rule:
    // from_chars on this signed type would also take a '-'
    if (b < e && *b == '+') ++b;
    if (b == e || *b == '-') return false;
    auto res = std::from_chars(b, e, *out);
    return res.ec == std::errc() && res.ptr == e;
}

bool parse_value(const char* b, const char* e, double* out) {
    if (b < e && *b == '+') ++b;
    if (b == e) return false;
    auto res = std::from_chars(b, e, *out, std::chars_format::general);
    return res.ec == std::errc() && res.ptr == e;
}

struct ErrorSlot {
    std::mutex mu;
    long long line = -1;  // earliest erroring line wins (Python parses in order)
    std::string message;

    void report(long long ln, std::string msg) {
        std::lock_guard<std::mutex> lock(mu);
        if (line < 0 || ln < line) {
            line = ln;
            message = std::move(msg);
        }
    }
    bool has_error() {
        std::lock_guard<std::mutex> lock(mu);
        return line >= 0;
    }
};

size_t num_threads_for(size_t work_items) {
    size_t hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    return std::max<size_t>(1, std::min(hw, std::max<size_t>(1, work_items / 256)));
}

template <typename Fn>
void parallel_for_lines(size_t n, Fn&& fn) {
    const size_t nt = num_threads_for(n);
    if (nt <= 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(nt);
    const size_t chunk = (n + nt - 1) / nt;
    for (size_t t = 0; t < nt; ++t) {
        const size_t lo = t * chunk;
        const size_t hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back([lo, hi, &fn] { fn(lo, hi); });
    }
    for (auto& th : threads) th.join();
}

// Format a double exactly like CPython's repr(): shortest round-trip digits,
// fixed notation for decimal exponent in [-4, 16), scientific otherwise
// (sign + >=2 exponent digits).  Keeps natively-written model files
// byte-identical to the Python writer (io/model_file.py::_fmt_g).
int py_repr(double v, char* buf) {
    if (!std::isfinite(v)) {
        // to_chars SUCCEEDS for inf/nan (writes "inf"/"nan" with no 'e'),
        // which would send the exponent scan past the terminator — handle
        // them up front, matching CPython repr(): 'inf', '-inf', 'nan'
        const char* s = std::isnan(v) ? "nan" : (v < 0 ? "-inf" : "inf");
        const int n = static_cast<int>(strlen(s));
        memcpy(buf, s, static_cast<size_t>(n) + 1);
        return n;
    }
    auto res = std::to_chars(buf, buf + 40, v, std::chars_format::scientific);
    int len = static_cast<int>(res.ptr - buf);
    if (res.ec != std::errc()) {  // cannot happen for finite v; be safe
        const int n = snprintf(buf, 48, "%g", v);
        return n;
    }
    buf[len] = '\0';  // atoi below must not run into uninitialized bytes
    // split "[-]D[.DDD]e±XX" into digits and exponent
    char digits[40];
    int nd = 0;
    int i = 0;
    bool neg = false;
    if (buf[i] == '-') { neg = true; ++i; }
    for (; i < len && buf[i] != 'e'; ++i) {
        if (buf[i] != '.') digits[nd++] = buf[i];
    }
    int exp10 = atoi(buf + i + 1);
    if (exp10 < -4 || exp10 >= 16) return len;  // scientific: as-is
    // fixed notation
    char out[64];
    int w = 0;
    if (neg) out[w++] = '-';
    if (exp10 >= 0) {
        for (int k = 0; k <= exp10; ++k) out[w++] = k < nd ? digits[k] : '0';
        out[w++] = '.';
        if (exp10 + 1 < nd) {
            for (int k = exp10 + 1; k < nd; ++k) out[w++] = digits[k];
        } else {
            out[w++] = '0';
        }
    } else {
        out[w++] = '0';
        out[w++] = '.';
        for (int k = 0; k < -exp10 - 1; ++k) out[w++] = '0';
        for (int k = 0; k < nd; ++k) out[w++] = digits[k];
    }
    memcpy(buf, out, static_cast<size_t>(w));
    buf[w] = '\0';
    return w;
}

}  // namespace

extern "C" {

struct PlssvmParseResult {
    double* data;     // n*d row-major (malloc'd; free with plssvm_free_result)
    int64_t n_total;  // total data points in the file (>= n for window parses)
    char* labels;     // n concatenated NUL-terminated labels (malloc'd), or NULL
    int64_t labels_bytes;
    int64_t n;
    int64_t d;
    int32_t has_labels;
    char error[512];
    double* coeffs;   // n*n_lead leading per-row floats (model SV blocks), or NULL
    int64_t n_lead;
};

static void set_error(PlssvmParseResult* out, const std::string& msg) {
    snprintf(out->error, sizeof(out->error), "%s", msg.c_str());
}

// RAII open/fstat/mmap shared by every reader entry point (the per-entry
// error WORDING and empty-window semantics stay at the call sites —
// they deliberately differ; this deduplicates only the scaffold).
// status: 0 ok, 2 io error; fail names the failed syscall for call sites
// that report it ("open" | "stat" | "mmap").
struct MappedFile {
    int fd = -1;
    const char* base = nullptr;
    size_t size = 0;
    int status = 0;
    const char* fail = nullptr;

    explicit MappedFile(const char* path) {
        fd = open(path, O_RDONLY);
        if (fd < 0) {
            status = 2;
            fail = "open";
            return;
        }
        struct stat st;
        if (fstat(fd, &st) != 0) {
            status = 2;
            fail = "stat";
            return;
        }
        size = static_cast<size_t>(st.st_size);
        if (size > 0) {
            void* map = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
            if (map == MAP_FAILED) {
                status = 2;
                fail = "mmap";
                base = nullptr;
                return;
            }
            base = static_cast<const char*>(map);
        }
    }
    ~MappedFile() {
        if (base) munmap(const_cast<char*>(base), size);
        if (fd >= 0) close(fd);
    }
    MappedFile(const MappedFile&) = delete;
    MappedFile& operator=(const MappedFile&) = delete;

    void set_io_error(PlssvmParseResult* out, const char* path) const {
        set_error(out, std::string("Couldn't ") + (fail ? fail : "read") +
                           " file: '" + path + "'!");
    }
};

// trimmed, non-empty, non-comment lines of [base + offset, base + size)
static std::vector<Line> split_lines(const MappedFile& mf, size_t offset,
                                     char comment, size_t reserve_div) {
    std::vector<Line> lines;
    lines.reserve((mf.size - offset) / reserve_div + 1);
    const char* p = mf.base + offset;
    const char* file_end = mf.base + mf.size;
    while (p < file_end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(file_end - p)));
        const char* line_end = nl ? nl : file_end;
        const char* b = p;
        const char* e = line_end;
        while (b < e && is_space(*b)) ++b;
        while (e > b && is_space(*(e - 1))) --e;
        if (b < e && *b != comment) lines.push_back({b, e});
        p = nl ? nl + 1 : file_end;
    }
    return lines;
}

void plssvm_free_result(PlssvmParseResult* out) {
    free(out->data);
    free(out->labels);
    free(out->coeffs);
    out->data = nullptr;
    out->labels = nullptr;
    out->coeffs = nullptr;
}

// Parse rows [row_begin, row_end) of a LIBSVM file (row_end < 0 -> all).
// The WHOLE file is still validated and scanned for the global feature
// count (d is the max index over every row, and label presence must be
// all-or-nothing file-wide), but only the window's rows are materialized:
// per-host memory for multi-host sharded ingest is O(rows_window * d)
// instead of O(n * d) (SURVEY.md §2.4 P4 multi-host plan; the reference
// parses everything on one host, libsvm_parsing.hpp:117).
// returns 0 on success, 1 on parse error (out->error set), 2 on IO error
int plssvm_parse_libsvm_window(const char* path, int64_t row_begin,
                               int64_t row_end, PlssvmParseResult* out) {
    memset(out, 0, sizeof(*out));

    MappedFile mf(path);
    if (mf.status != 0) {
        mf.set_io_error(out, path);
        return 2;
    }

    // ---- split into trimmed, non-empty, non-comment lines ----
    std::vector<Line> lines = split_lines(mf, 0, '#', 64);

    const size_t n = lines.size();
    if (n == 0) {
        set_error(out, "Can't parse file: no data points are given!");
        return 1;
    }

    // ---- pass 1 (parallel): validate, find feature count, locate labels ----
    ErrorSlot err;
    std::atomic<bool> any_label{false};
    std::atomic<bool> any_no_label{false};
    std::atomic<bool> any_feature{false};
    std::atomic<long long> max_index{0};
    std::vector<Line> label_tokens(n, {nullptr, nullptr});

    parallel_for_lines(n, [&](size_t lo, size_t hi) {
        long long local_max = 0;
        for (size_t i = lo; i < hi; ++i) {
            if (err.has_error()) return;
            const Line& ln = lines[i];
            const char* q = ln.begin;
            // leading label token?
            if (has_label(ln)) {
                any_label.store(true, std::memory_order_relaxed);
                const char* tok_end = q;
                while (tok_end < ln.end && !is_space(*tok_end)) ++tok_end;
                label_tokens[i] = {q, tok_end};
                q = tok_end;
            } else {
                any_no_label.store(true, std::memory_order_relaxed);
            }
            long long last_index = 0;
            while (q < ln.end) {
                while (q < ln.end && is_space(*q)) ++q;
                if (q >= ln.end) break;
                const char* tok_end = q;
                while (tok_end < ln.end && !is_space(*tok_end)) ++tok_end;
                const char* colon = static_cast<const char*>(
                    memchr(q, ':', static_cast<size_t>(tok_end - q)));
                if (colon == nullptr) {
                    err.report(static_cast<long long>(i),
                               "Can't convert '" + std::string(q, tok_end) +
                                   "' to a LIBSVM index:value pair!");
                    return;
                }
                long long index;
                if (!parse_index(q, colon, &index)) {
                    err.report(static_cast<long long>(i),
                               "Can't convert '" + std::string(q, colon) +
                                   "' to a value of type unsigned long!");
                    return;
                }
                if (index == 0) {
                    err.report(static_cast<long long>(i),
                               "LIBSVM assumes a 1-based feature indexing scheme, "
                               "but 0 was given!");
                    return;
                }
                if (last_index >= index) {
                    err.report(static_cast<long long>(i),
                               "The features indices must be strictly increasing, "
                               "but " + std::to_string(index) +
                                   " is smaller or equal than " +
                                   std::to_string(last_index) + "!");
                    return;
                }
                last_index = index;
                double value;
                if (!parse_value(colon + 1, tok_end, &value)) {
                    err.report(static_cast<long long>(i),
                               "Can't convert '" + std::string(colon + 1, tok_end) +
                                   "' to a value of type real_type!");
                    return;
                }
                local_max = std::max(local_max, index);
                any_feature.store(true, std::memory_order_relaxed);
                q = tok_end;
            }
        }
        // lock-free max merge
        long long seen = max_index.load(std::memory_order_relaxed);
        while (local_max > seen &&
               !max_index.compare_exchange_weak(seen, local_max)) {
        }
    });

    if (err.has_error()) {
        set_error(out, err.message);
        return 1;
    }
    const bool got_labels = any_label.load();
    if (got_labels && any_no_label.load()) {
        set_error(out,
                  "Inconsistent label specification found "
                  "(some data points are labeled, others are not)!");
        return 1;
    }
    if (!any_feature.load()) {
        set_error(out, "Can't parse file: no data points are given!");
        return 1;
    }

    const long long d = max_index.load();

    // ---- clamp the requested row window ----
    const size_t rb = static_cast<size_t>(
        std::min<int64_t>(std::max<int64_t>(row_begin, 0),
                          static_cast<int64_t>(n)));
    const size_t re = row_end < 0
        ? n
        : static_cast<size_t>(
              std::min<int64_t>(row_end, static_cast<int64_t>(n)));
    const size_t nl = re > rb ? re - rb : 0;

    double* data = static_cast<double*>(
        calloc(std::max<size_t>(nl, 1) * static_cast<size_t>(d), sizeof(double)));
    if (data == nullptr) {
        set_error(out, "Out of memory allocating the data matrix!");
        return 2;
    }

    // ---- pass 2 (parallel): fill the dense matrix for the window ----
    parallel_for_lines(nl, [&](size_t lo, size_t hi) {
        for (size_t w = lo; w < hi; ++w) {
            const size_t i = rb + w;
            const Line& ln = lines[i];
            const char* q = label_tokens[i].begin ? label_tokens[i].end : ln.begin;
            double* row = data + w * static_cast<size_t>(d);
            while (q < ln.end) {
                while (q < ln.end && is_space(*q)) ++q;
                if (q >= ln.end) break;
                const char* tok_end = q;
                while (tok_end < ln.end && !is_space(*tok_end)) ++tok_end;
                const char* colon = static_cast<const char*>(
                    memchr(q, ':', static_cast<size_t>(tok_end - q)));
                long long index = 0;
                double value = 0.0;
                parse_index(q, colon, &index);          // validated in pass 1
                parse_value(colon + 1, tok_end, &value);
                row[index - 1] = value;
                q = tok_end;
            }
        }
    });

    // ---- labels buffer: concatenated NUL-terminated strings ----
    // ---- labels: always the FULL file's labels (window parses need the
    // global label set for consistent {-1,+1} mapping; labels are
    // metadata-scale, O(n) strings vs the O(n d) matrix) ----
    char* labels_buf = nullptr;
    int64_t labels_bytes = 0;
    if (got_labels) {
        size_t total = 0;
        for (size_t i = 0; i < n; ++i) {
            total += static_cast<size_t>(label_tokens[i].end - label_tokens[i].begin) + 1;
        }
        labels_buf = static_cast<char*>(malloc(total));
        if (labels_buf == nullptr) {
            free(data);
            set_error(out, "Out of memory allocating the labels buffer!");
            return 2;
        }
        char* w = labels_buf;
        for (size_t i = 0; i < n; ++i) {
            const size_t len =
                static_cast<size_t>(label_tokens[i].end - label_tokens[i].begin);
            memcpy(w, label_tokens[i].begin, len);
            w += len;
            *w++ = '\0';
        }
        labels_bytes = static_cast<int64_t>(total);
    }

    out->data = data;
    out->labels = labels_buf;
    out->labels_bytes = labels_bytes;
    out->n = static_cast<int64_t>(nl);
    out->n_total = static_cast<int64_t>(n);
    out->d = d;
    out->has_labels = got_labels ? 1 : 0;
    return 0;
}

int plssvm_parse_libsvm(const char* path, PlssvmParseResult* out) {
    return plssvm_parse_libsvm_window(path, 0, -1, out);
}

// Sparse writer: zero features omitted, "{idx}:{:.10e} " formatting
// (reference libsvm_parsing.hpp:243-300).  labels == NULL writes no label
// column; labels otherwise points at n concatenated NUL-terminated strings.
// returns 0 on success, 2 on IO error.
}  // extern "C" — the write helpers below are C++ internals (a
   // template cannot carry C linkage); the public entry points reopen
   // the block right after

// offsets into a NUL-concatenated label buffer (one sequential scan)
static std::vector<const char*> label_offsets(const char* labels,
                                              int64_t n) {
    std::vector<const char*> label_ptr;
    if (labels != nullptr) {
        label_ptr.resize(static_cast<size_t>(n));
        const char* q = labels;
        for (int64_t i = 0; i < n; ++i) {
            label_ptr[static_cast<size_t>(i)] = q;
            q += strlen(q) + 1;
        }
    }
    return label_ptr;
}

// The shared writer scaffold: open, optional header, rows formatted in
// parallel into per-thread buffers (format_row appends ONE row, index i,
// to its buffer), then one sequential fwrite pass — byte-identical to a
// sequential writer.  Returns 0 on success, 2 on IO error.
template <typename RowFn>
static int threaded_write(const char* path, const char* header,
                          int64_t n, size_t reserve_per_row,
                          RowFn&& format_row) {
    FILE* fh = fopen(path, "w");
    if (fh == nullptr) return 2;
    if (header != nullptr) {
        const size_t header_len = strlen(header);
        if (header_len > 0 &&
            fwrite(header, 1, header_len, fh) != header_len) {
            fclose(fh);
            return 2;
        }
    }

    const size_t nt = num_threads_for(static_cast<size_t>(n));
    const int64_t chunk =
        (n + static_cast<int64_t>(nt) - 1) / static_cast<int64_t>(nt);
    std::vector<std::string> buffers(nt);
    std::vector<std::thread> threads;
    for (size_t t = 0; t < nt; ++t) {
        const int64_t lo = static_cast<int64_t>(t) * chunk;
        const int64_t hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back([&, t, lo, hi] {
            std::string& buf = buffers[t];
            buf.reserve(static_cast<size_t>(hi - lo) * reserve_per_row);
            for (int64_t i = lo; i < hi; ++i) format_row(buf, i);
        });
    }
    for (auto& th : threads) th.join();

    int rc = 0;
    for (const std::string& buf : buffers) {
        if (!buf.empty() &&
            fwrite(buf.data(), 1, buf.size(), fh) != buf.size()) {
            rc = 2;
            break;
        }
    }
    if (fclose(fh) != 0) rc = 2;
    return rc;
}

extern "C" {

int plssvm_write_libsvm(const char* path, const double* data, int64_t n,
                        int64_t d, const char* labels) {
    std::vector<const char*> label_ptr = label_offsets(labels, n);
    return threaded_write(
        path, nullptr, n, static_cast<size_t>(d) * 8,
        [&](std::string& buf, int64_t i) {
            char tmp[64];
            if (labels != nullptr) {
                buf += label_ptr[static_cast<size_t>(i)];
                buf += ' ';
            }
            const double* row = data + i * d;
            for (int64_t j = 0; j < d; ++j) {
                if (row[j] != 0.0) {
                    const int len =
                        snprintf(tmp, sizeof(tmp), "%lld:%.10e ",
                                 static_cast<long long>(j + 1), row[j]);
                    buf.append(tmp, static_cast<size_t>(len));
                }
            }
            buf += '\n';
        });
}

// Parse the SV block of a LIBSVM model file starting at byte `offset`
// (just past the "SV" header line): each row is `n_lead` plain floats
// (alpha columns — 1 for binary models, C for one-vs-all multiclass)
// followed by sparse `idx:val` features (reference:
// libsvm_model_parsing.hpp:294-500; the Python equivalent is
// io/model_file.py::parse_model_file).
// Returns 0 on success, 2 on IO error, 3 on ANY content anomaly — the
// caller falls back to the Python parser, which produces the exact
// reference error message for every invalid-file case.
int plssvm_parse_model_svs(const char* path, int64_t offset, int64_t n_lead,
                           PlssvmParseResult* out) {
    memset(out, 0, sizeof(*out));
    if (n_lead < 1) return 3;

    MappedFile mf(path);
    if (mf.status != 0) {
        if (mf.fail && std::string(mf.fail) == "open") {
            set_error(out,
                      std::string("Couldn't open file: '") + path + "'!");
        }
        return 2;
    }
    if (offset < 0 || static_cast<size_t>(offset) > mf.size) {
        return 3;
    }

    std::vector<Line> lines =
        split_lines(mf, static_cast<size_t>(offset), '#', 64);

    const size_t n = lines.size();
    if (n == 0) {
        return 3;
    }

    // ---- pass 1 (parallel): validate rows, find the feature count ----
    std::atomic<bool> bad{false};
    std::atomic<long long> max_index{0};
    std::vector<const char*> feat_begin(n, nullptr);  // first idx:val token

    parallel_for_lines(n, [&](size_t lo, size_t hi) {
        long long local_max = 0;
        for (size_t i = lo; i < hi; ++i) {
            if (bad.load(std::memory_order_relaxed)) return;
            const Line& ln = lines[i];
            const char* q = ln.begin;
            for (int64_t lead = 0; lead < n_lead; ++lead) {
                while (q < ln.end && is_space(*q)) ++q;
                const char* tok_end = q;
                while (tok_end < ln.end && !is_space(*tok_end)) ++tok_end;
                double value;
                if (q >= ln.end ||
                    memchr(q, ':', static_cast<size_t>(tok_end - q)) != nullptr ||
                    !parse_value(q, tok_end, &value)) {
                    bad.store(true, std::memory_order_relaxed);
                    return;
                }
                q = tok_end;
            }
            feat_begin[i] = q;
            long long last_index = 0;
            while (q < ln.end) {
                while (q < ln.end && is_space(*q)) ++q;
                if (q >= ln.end) break;
                const char* tok_end = q;
                while (tok_end < ln.end && !is_space(*tok_end)) ++tok_end;
                const char* colon = static_cast<const char*>(
                    memchr(q, ':', static_cast<size_t>(tok_end - q)));
                long long index;
                double value;
                if (colon == nullptr || !parse_index(q, colon, &index) ||
                    index <= 0 || last_index >= index ||
                    !parse_value(colon + 1, tok_end, &value)) {
                    bad.store(true, std::memory_order_relaxed);
                    return;
                }
                last_index = index;
                local_max = std::max(local_max, index);
                q = tok_end;
            }
        }
        long long seen = max_index.load(std::memory_order_relaxed);
        while (local_max > seen &&
               !max_index.compare_exchange_weak(seen, local_max)) {
        }
    });

    if (bad.load() || max_index.load() == 0) {
        return 3;
    }
    const long long d = max_index.load();

    double* data = static_cast<double*>(
        calloc(n * static_cast<size_t>(d), sizeof(double)));
    double* coeffs = static_cast<double*>(
        malloc(n * static_cast<size_t>(n_lead) * sizeof(double)));
    if (data == nullptr || coeffs == nullptr) {
        free(data);
        free(coeffs);
        set_error(out, "Out of memory allocating the data matrix!");
        return 2;
    }

    // ---- pass 2 (parallel): fill coefficients + dense features ----
    parallel_for_lines(n, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; ++i) {
            const Line& ln = lines[i];
            const char* q = ln.begin;
            double* crow = coeffs + i * static_cast<size_t>(n_lead);
            for (int64_t lead = 0; lead < n_lead; ++lead) {
                while (q < ln.end && is_space(*q)) ++q;
                const char* tok_end = q;
                while (tok_end < ln.end && !is_space(*tok_end)) ++tok_end;
                parse_value(q, tok_end, &crow[lead]);  // validated in pass 1
                q = tok_end;
            }
            double* row = data + i * static_cast<size_t>(d);
            while (q < ln.end) {
                while (q < ln.end && is_space(*q)) ++q;
                if (q >= ln.end) break;
                const char* tok_end = q;
                while (tok_end < ln.end && !is_space(*tok_end)) ++tok_end;
                const char* colon = static_cast<const char*>(
                    memchr(q, ':', static_cast<size_t>(tok_end - q)));
                long long index = 0;
                double value = 0.0;
                parse_index(q, colon, &index);
                parse_value(colon + 1, tok_end, &value);
                row[index - 1] = value;
                q = tok_end;
            }
        }
    });

    out->data = data;
    out->coeffs = coeffs;
    out->n_lead = n_lead;
    out->n = static_cast<int64_t>(n);
    out->n_total = static_cast<int64_t>(n);
    out->d = d;
    return 0;
}

// Parse the data section of an ARFF file starting at byte `offset` (just
// past the "@DATA" line): dense "v,...,label" rows (label at comma position
// `label_idx` of num_features+has_label fields) and sparse "{idx val, ...}"
// rows with zero-based indices (reference: arff_parsing.hpp:236-376; Python
// equivalent io/arff.py::parse_arff_lines).  Comment lines start with '%'.
// Returns 0 on success, 2 on IO error, 3 on ANY content anomaly — the
// caller falls back to the Python parser for the exact error message.
// Parse the ARFF data section starting at byte `offset`, materializing
// features ONLY for rows [row_begin, row_end) (row_end < 0 = all rows).
// Every row is still fully validated and the label column is returned for
// the WHOLE section (global metadata, mirroring plssvm_parse_libsvm_window)
// — the windowed per-host ingest of io/arff.py::parse_arff_file_window.
int plssvm_parse_arff_window(const char* path, int64_t offset,
                             int64_t num_features, int64_t label_idx,
                             int32_t has_label, int64_t row_begin,
                             int64_t row_end, PlssvmParseResult* out) {
    memset(out, 0, sizeof(*out));
    if (num_features <= 0 || row_begin < 0) return 3;
    const int64_t num_attributes = num_features + (has_label ? 1 : 0);

    MappedFile mf(path);
    if (mf.status != 0) return 2;
    if (offset < 0 || static_cast<size_t>(offset) > mf.size) {
        return 3;
    }

    std::vector<Line> lines =
        split_lines(mf, static_cast<size_t>(offset), '%', 32);

    const size_t n = lines.size();
    if (n == 0) {
        return 3;
    }
    const size_t wb = std::min(static_cast<size_t>(row_begin), n);
    const size_t we =
        row_end < 0 ? n : std::min(static_cast<size_t>(row_end), n);
    if (wb > we) {
        return 3;
    }
    const size_t window_n = we - wb;

    // +1 keeps the allocation non-null for empty (metadata-only) windows
    double* data = static_cast<double*>(calloc(
        window_n * static_cast<size_t>(num_features) + 1, sizeof(double)));
    std::vector<Line> label_tokens(n, {nullptr, nullptr});
    if (data == nullptr) {
        return 2;
    }

    std::atomic<bool> bad{false};
    parallel_for_lines(n, [&](size_t lo, size_t hi) {
        // rows outside the window are fully validated but their features
        // land in a per-chunk scratch row and are discarded
        std::vector<double> scratch(static_cast<size_t>(num_features));
        for (size_t i = lo; i < hi; ++i) {
            if (bad.load(std::memory_order_relaxed)) return;
            const Line& ln = lines[i];
            const bool in_window = i >= wb && i < we;
            double* row =
                in_window
                    ? data + (i - wb) * static_cast<size_t>(num_features)
                    : scratch.data();
            if (*ln.begin == '@') {
                bad.store(true, std::memory_order_relaxed);
                return;
            }
            if (*ln.begin == '{') {
                if (*(ln.end - 1) != '}') {
                    bad.store(true, std::memory_order_relaxed);
                    return;
                }
                bool class_set = false;
                const char* q = ln.begin + 1;
                const char* body_end = ln.end - 1;
                while (q < body_end) {
                    // entry: "idx value", entries comma-separated
                    const char* entry_end = static_cast<const char*>(
                        memchr(q, ',', static_cast<size_t>(body_end - q)));
                    if (entry_end == nullptr) entry_end = body_end;
                    const char* b = q;
                    const char* e = entry_end;
                    while (b < e && is_space(*b)) ++b;
                    while (e > b && is_space(*(e - 1))) --e;
                    q = entry_end + 1;
                    if (b >= e) continue;  // empty body "{}" handled below
                    const char* idx_end = b;
                    while (idx_end < e && !is_space(*idx_end)) ++idx_end;
                    const char* val_begin = idx_end;
                    while (val_begin < e && is_space(*val_begin)) ++val_begin;
                    long long index;
                    if (val_begin >= e || !parse_index(b, idx_end, &index) ||
                        index < 0 || index >= num_attributes) {
                        bad.store(true, std::memory_order_relaxed);
                        return;
                    }
                    if (has_label && index == label_idx) {
                        class_set = true;
                        label_tokens[i] = {val_begin, e};
                    } else {
                        double value;
                        if (!parse_value(val_begin, e, &value)) {
                            bad.store(true, std::memory_order_relaxed);
                            return;
                        }
                        if (has_label && index > label_idx) --index;
                        row[index] = value;
                    }
                }
                if (has_label && !class_set) {
                    bad.store(true, std::memory_order_relaxed);
                    return;
                }
            } else {
                if (*(ln.end - 1) == '}') {
                    bad.store(true, std::memory_order_relaxed);
                    return;
                }
                const char* q = ln.begin;
                long long field = 0;
                long long feat = 0;
                while (q <= ln.end) {
                    const char* tok_end = static_cast<const char*>(
                        memchr(q, ',', static_cast<size_t>(ln.end - q)));
                    if (tok_end == nullptr) tok_end = ln.end;
                    const char* b = q;
                    const char* e = tok_end;
                    while (b < e && is_space(*b)) ++b;
                    while (e > b && is_space(*(e - 1))) --e;
                    if (field >= num_attributes) {
                        bad.store(true, std::memory_order_relaxed);
                        return;
                    }
                    if (has_label && field == label_idx) {
                        label_tokens[i] = {b, e};
                    } else {
                        double value;
                        if (!parse_value(b, e, &value)) {
                            bad.store(true, std::memory_order_relaxed);
                            return;
                        }
                        row[feat++] = value;
                    }
                    ++field;
                    if (tok_end == ln.end) break;
                    q = tok_end + 1;
                }
                if (field != num_attributes) {
                    bad.store(true, std::memory_order_relaxed);
                    return;
                }
            }
        }
    });

    if (bad.load()) {
        free(data);
        return 3;
    }

    char* labels_buf = nullptr;
    int64_t labels_bytes = 0;
    if (has_label) {
        size_t total = 0;
        for (size_t i = 0; i < n; ++i) {
            total += static_cast<size_t>(
                         label_tokens[i].end - label_tokens[i].begin) + 1;
        }
        labels_buf = static_cast<char*>(malloc(total));
        if (labels_buf == nullptr) {
            free(data);
            return 2;
        }
        char* w = labels_buf;
        for (size_t i = 0; i < n; ++i) {
            const size_t len = static_cast<size_t>(
                label_tokens[i].end - label_tokens[i].begin);
            memcpy(w, label_tokens[i].begin, len);
            w += len;
            *w++ = '\0';
        }
        labels_bytes = static_cast<int64_t>(total);
    }

    out->data = data;
    out->labels = labels_buf;
    out->labels_bytes = labels_bytes;
    out->n = static_cast<int64_t>(window_n);
    out->n_total = static_cast<int64_t>(n);
    out->d = num_features;
    out->has_labels = has_label ? 1 : 0;
    return 0;
}

int plssvm_parse_arff_data(const char* path, int64_t offset,
                           int64_t num_features, int64_t label_idx,
                           int32_t has_label, PlssvmParseResult* out) {
    return plssvm_parse_arff_window(path, offset, num_features, label_idx,
                                    has_label, 0, -1, out);
}

// Write an ARFF data file: `header` verbatim (through the "@DATA" line),
// then dense "{:.10e},...,label" rows (zeros included — reference:
// arff_parsing.hpp:407-459).  labels == NULL writes no label column.
// Returns 0 on success, 2 on IO error.
int plssvm_write_arff(const char* path, const char* header,
                      const double* data, int64_t n, int64_t d,
                      const char* labels) {
    std::vector<const char*> label_ptr = label_offsets(labels, n);
    return threaded_write(
        path, header, n, static_cast<size_t>(d) * 18 + 16,
        [&](std::string& buf, int64_t i) {
            char tmp[40];
            const double* row = data + i * d;
            for (int64_t j = 0; j < d; ++j) {
                const int len = snprintf(tmp, sizeof(tmp), "%.10e,", row[j]);
                buf.append(tmp, static_cast<size_t>(len));
            }
            if (labels != nullptr) {
                buf += label_ptr[static_cast<size_t>(i)];
            } else if (d > 0) {
                buf.pop_back();  // drop the trailing comma
            }
            buf += '\n';
        });
}

// Write a LIBSVM model file: `header` verbatim (must end with "SV\n"), then
// one row per support vector in `order` permutation (class-grouped by the
// caller): n_coeffs alpha values (CPython repr formatting — byte-identical
// to the Python writer) followed by sparse "{idx}:{:.10e} " features.
// Returns 0 on success, 2 on IO error.
int plssvm_write_model(const char* path, const char* header,
                       const double* data, const double* coeffs,
                       const int64_t* order, int64_t n, int64_t d,
                       int64_t n_coeffs) {
    return threaded_write(
        path, header, n, static_cast<size_t>(d + n_coeffs) * 8,
        [&](std::string& buf, int64_t w) {
            char tmp[64];
            const int64_t i = order ? order[w] : w;
            const double* crow = coeffs + i * n_coeffs;
            for (int64_t c = 0; c < n_coeffs; ++c) {
                const int len = py_repr(crow[c], tmp);
                buf.append(tmp, static_cast<size_t>(len));
                buf += ' ';
            }
            const double* row = data + i * d;
            for (int64_t j = 0; j < d; ++j) {
                if (row[j] != 0.0) {
                    const int len =
                        snprintf(tmp, sizeof(tmp), "%lld:%.10e ",
                                 static_cast<long long>(j + 1), row[j]);
                    buf.append(tmp, static_cast<size_t>(len));
                }
            }
            buf += '\n';
        });
}

// Byte spans [begin, end) of every DATA line (comments/blank skipped), in
// file order: 2*n int64 values written to a malloc'd buffer.  One cheap
// memchr sweep — the index a streaming consumer (windowed Nystroem ingest,
// sparse.py::nystroem_fit_from_file) builds ONCE so that every subsequent
// plssvm_parse_libsvm_rows call is O(selected rows), not O(file).
// returns 0 on success, 2 on IO error.  Free with plssvm_free_spans.
int plssvm_libsvm_line_spans(const char* path, int64_t** spans_out,
                             int64_t* n_out) {
    *spans_out = nullptr;
    *n_out = 0;
    MappedFile mf(path);
    if (mf.status != 0) return 2;
    std::vector<Line> lines = split_lines(mf, 0, '#', 32);
    std::vector<int64_t> spans;
    spans.reserve(2 * lines.size());
    for (const Line& ln : lines) {
        spans.push_back(static_cast<int64_t>(ln.begin - mf.base));
        spans.push_back(static_cast<int64_t>(ln.end - mf.base));
    }
    int64_t* out = static_cast<int64_t*>(
        malloc(std::max<size_t>(spans.size(), 1) * sizeof(int64_t)));
    if (out == nullptr) return 2;
    if (!spans.empty())
        memcpy(out, spans.data(), spans.size() * sizeof(int64_t));
    *spans_out = out;
    *n_out = static_cast<int64_t>(spans.size() / 2);
    return 0;
}

void plssvm_free_spans(int64_t* spans) { free(spans); }

// Parse SELECTED data rows into a dense (nrows, known_d) matrix WITHOUT
// re-validating the whole file: `spans` carries 2*nrows byte offsets
// [begin, end) of the requested lines (subset of plssvm_libsvm_line_spans'
// output for a file already validated by a metadata parse).  Labels are
// skipped per line; per-token checks stay (malformed content errors
// rather than corrupting), but no global properties are re-derived —
// per-call cost is O(selected rows * d).
// returns 0 ok, 1 content error (message in out->error), 2 IO error.
int plssvm_parse_libsvm_rows(const char* path, const int64_t* spans,
                             int64_t nrows, int64_t known_d,
                             PlssvmParseResult* out) {
    memset(out, 0, sizeof(*out));
    if (nrows < 0 || known_d <= 0) {
        set_error(out, "invalid nrows/known_d for selected-row parse!");
        return 1;
    }
    MappedFile mf(path);
    if (mf.status != 0) {
        mf.set_io_error(out, path);
        return 2;
    }
    const char* base = mf.base;
    const size_t size = mf.size;

    double* data = static_cast<double*>(
        calloc(std::max<int64_t>(nrows, 1) * static_cast<size_t>(known_d),
               sizeof(double)));
    if (data == nullptr) {
        set_error(out, "Out of memory allocating the data matrix!");
        return 2;
    }

    ErrorSlot err;
    parallel_for_lines(static_cast<size_t>(nrows), [&](size_t lo, size_t hi) {
        for (size_t w = lo; w < hi; ++w) {
            if (err.has_error()) return;
            const int64_t b_off = spans[2 * w];
            const int64_t e_off = spans[2 * w + 1];
            if (b_off < 0 || e_off < b_off ||
                static_cast<size_t>(e_off) > size) {
                err.report(static_cast<long long>(w),
                           "line span out of file bounds!");
                return;
            }
            Line ln{base + b_off, base + e_off};
            const char* q = ln.begin;
            if (has_label(ln)) {
                while (q < ln.end && !is_space(*q)) ++q;
            }
            double* row = data + w * static_cast<size_t>(known_d);
            while (q < ln.end) {
                while (q < ln.end && is_space(*q)) ++q;
                if (q >= ln.end) break;
                const char* tok_end = q;
                while (tok_end < ln.end && !is_space(*tok_end)) ++tok_end;
                const char* colon = static_cast<const char*>(
                    memchr(q, ':', static_cast<size_t>(tok_end - q)));
                long long index = 0;
                double value = 0.0;
                if (colon == nullptr || !parse_index(q, colon, &index) ||
                    index < 1 || index > known_d ||
                    !parse_value(colon + 1, tok_end, &value)) {
                    err.report(static_cast<long long>(w),
                               "Can't convert '" + std::string(q, tok_end) +
                                   "' to a LIBSVM index:value pair!");
                    return;
                }
                row[index - 1] = value;
                q = tok_end;
            }
        }
    });

    if (err.has_error()) {
        free(data);
        set_error(out, err.message);
        return 1;
    }
    out->data = data;
    out->n = nrows;
    out->n_total = nrows;
    out->d = known_d;
    return 0;
}

}  // extern "C"
