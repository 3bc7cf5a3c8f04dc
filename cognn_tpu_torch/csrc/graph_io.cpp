// Native graph file parsing for cognn_tpu_torch (the port's copy of the JAX
// package's native/graph_io.cpp; a host library, built by the host C++
// compiler, not nvcc).
//
// Counterpart of the reference's C++ loader layer (include/graph_io_util.h:
// 41-208: strtoull fast path + 8-thread load pool; algo_kernels/
// common_harness/harness.cpp:21-48 loadVertexData). Python's text parsing
// (np.loadtxt) is several times slower on the vertex files (V x input_dim
// doubles); this library reads the file and parses with strtoll/strtod
// across a thread pool, filling caller-provided buffers.
//
// C ABI (ctypes):
//   cognn_set_threads(n)                          -> the pool size, 0 = auto
//   cognn_count_rows(path)                        -> rows (non-empty, non-#)
//   cognn_parse_edge_list(path, n, src, dst, w, default_w) -> rows or -err
//   cognn_parse_vertex_file(path, n, cols, vid, feat, label) -> rows or -err
//
// Two-pass protocol: count first, then allocate numpy arrays and fill.
// Every token must lie on its own row: a short row is malformed (-2000),
// never completed from the next one.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <utility>
#include <vector>

namespace {

// The whole file in memory with a NUL after its last byte, so that strtoll
// and strtod stop there even on a last row without a newline (a mapping
// that ends at a page boundary would let them read past it).
struct FileText {
    std::vector<char> buf;
    const char* data = nullptr;
    size_t size = 0;
    int err = 0;  // errno of a failed open/read, else 0
};

FileText read_file(const char* path) {
    FileText m;
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) {
        m.err = errno ? errno : 1;
        return m;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
        m.err = errno ? errno : 1;
        ::close(fd);
        return m;
    }
    m.buf.resize(static_cast<size_t>(st.st_size) + 1, '\0');
    size_t got = 0;
    while (got < static_cast<size_t>(st.st_size)) {
        ssize_t n = ::read(fd, m.buf.data() + got, st.st_size - got);
        if (n < 0 && errno == EINTR) continue;
        if (n <= 0) {
            m.err = n < 0 ? errno : EIO;
            ::close(fd);
            return m;
        }
        got += static_cast<size_t>(n);
    }
    ::close(fd);
    m.data = m.buf.data();
    m.size = got;
    return m;
}

inline bool is_blank(char c) { return c == ' ' || c == '\t' || c == '\r'; }

inline bool effective_line(const char* b, const char* e) {
    while (b < e && is_blank(*b)) ++b;
    return b < e && *b != '#' && *b != '\n';
}

// [start, end) offsets of the effective lines.
std::vector<std::pair<size_t, size_t>> line_spans(const FileText& m) {
    std::vector<std::pair<size_t, size_t>> spans;
    size_t start = 0;
    for (size_t i = 0; i <= m.size; ++i) {
        if (i == m.size || m.data[i] == '\n') {
            if (effective_line(m.data + start, m.data + i))
                spans.emplace_back(start, i);
            start = i + 1;
        }
    }
    return spans;
}

// The next token of [p, end) as a number, or false where there is none
// before the row's end (strtoll/strtod would skip the newline).
inline bool next_ll(const char*& p, const char* end, long long* out) {
    while (p < end && is_blank(*p)) ++p;
    if (p >= end) return false;
    char* stop = nullptr;
    *out = strtoll(p, &stop, 10);
    if (stop == p || stop > end) return false;
    p = stop;
    return true;
}

inline bool next_d(const char*& p, const char* end, double* out) {
    while (p < end && is_blank(*p)) ++p;
    if (p >= end) return false;
    char* stop = nullptr;
    *out = strtod(p, &stop);
    if (stop == p || stop > end) return false;
    p = stop;
    return true;
}

// 0 = auto (hardware_concurrency, capped); set via cognn_set_threads
// (the harness's -t flag, reference harness.h:25 "-t threads").
int64_t g_thread_override = 0;

unsigned worker_count(size_t rows) {
    if (g_thread_override > 0)
        return static_cast<unsigned>(std::min<int64_t>(g_thread_override,
                                                       64));
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    if (hw > 16) hw = 16;  // matches the reference's bounded load pool
    if (rows < 4096) return 1;
    return hw;
}

template <typename Fn>
void parallel_rows(size_t rows, Fn fn) {
    unsigned nw = worker_count(rows);
    if (nw <= 1) {
        fn(0, rows);
        return;
    }
    std::vector<std::thread> threads;
    size_t chunk = (rows + nw - 1) / nw;
    for (unsigned t = 0; t < nw; ++t) {
        size_t lo = t * chunk, hi = std::min(rows, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back([=]() { fn(lo, hi); });
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void cognn_set_threads(int64_t n) { g_thread_override = n; }

int64_t cognn_count_rows(const char* path) {
    FileText m = read_file(path);
    if (m.err) return -static_cast<int64_t>(m.err);
    return static_cast<int64_t>(line_spans(m).size());
}

// Parse "<src> <dst> [w]" rows. Returns rows filled, or negative on error.
int64_t cognn_parse_edge_list(const char* path, int64_t capacity,
                              int64_t* src, int64_t* dst, double* w,
                              double default_w) {
    FileText m = read_file(path);
    if (m.err) return -static_cast<int64_t>(m.err);
    auto spans = line_spans(m);
    int64_t rows = static_cast<int64_t>(spans.size());
    if (rows > capacity) return -1000;  // caller under-allocated
    std::atomic<int> bad{0};
    parallel_rows(rows, [&](size_t lo, size_t hi) {
        for (size_t r = lo; r < hi; ++r) {
            const char* p = m.data + spans[r].first;
            const char* end = m.data + spans[r].second;
            long long s, d;
            if (!next_ll(p, end, &s) || !next_ll(p, end, &d)) {
                bad = 1;
                return;
            }
            double weight = default_w;
            while (p < end && is_blank(*p)) ++p;
            if (p < end && *p != '#' && !next_d(p, end, &weight)) {
                bad = 1;
                return;
            }
            src[r] = s;
            dst[r] = d;
            if (w) w[r] = weight;
        }
    });
    if (bad) return -2000;  // malformed row
    return rows;
}

// Parse "<vid> <f0> ... <f{cols-1}> <label>" rows.
int64_t cognn_parse_vertex_file(const char* path, int64_t capacity,
                                int64_t cols, int64_t* vid, double* feat,
                                int64_t* label) {
    FileText m = read_file(path);
    if (m.err) return -static_cast<int64_t>(m.err);
    auto spans = line_spans(m);
    int64_t rows = static_cast<int64_t>(spans.size());
    if (rows > capacity) return -1000;
    std::atomic<int> bad{0};
    parallel_rows(rows, [&](size_t lo, size_t hi) {
        for (size_t r = lo; r < hi; ++r) {
            const char* p = m.data + spans[r].first;
            const char* end = m.data + spans[r].second;
            long long v, lab;
            if (!next_ll(p, end, &v)) {
                bad = 1;
                return;
            }
            double* row = feat + r * cols;
            for (int64_t c = 0; c < cols; ++c) {
                if (!next_d(p, end, &row[c])) {
                    bad = 1;
                    return;
                }
            }
            if (!next_ll(p, end, &lab)) {
                bad = 1;
                return;
            }
            // reject extra trailing tokens (column-count mismatch)
            while (p < end && is_blank(*p)) ++p;
            if (p != end) {
                bad = 1;
                return;
            }
            vid[r] = v;
            label[r] = lab;
        }
    });
    if (bad) return -2000;
    return rows;
}

}  // extern "C"
