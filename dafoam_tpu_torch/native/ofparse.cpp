// Native OpenFOAM polyMesh field parser (host-side IO runtime) of
// dafoam_tpu_torch; the same source as dafoam_tpu's native parser.
//
// DAFoam reads meshes through pyofm, a C++ OpenFOAM reader (pyDAFoam.py
// _readOFGrid). This is the port's native equivalent: a small C++ library
// that parses the number-heavy payloads of constant/polyMesh/{points,
// faces,owner,neighbour} at memory-bandwidth-class speed, loaded from
// Python via ctypes (no pybind11 needed). The Python reader
// (dafoam_tpu_torch/mesh/polymesh.py) keeps a pure-numpy path for every
// format; this one exists because regex-tokenising a multi-million-face
// ASCII mesh in Python takes minutes where this takes milliseconds.
//
// Exported C ABI (all buffers malloc'd here, released with of_free):
//   of_parse_labels_ascii(buf, n, out_vals, out_n)    -> int64*
//   of_parse_points_ascii(buf, n, out_vals, out_n)    -> double*  (3*n)
//   of_parse_faces_ascii (buf, n, out_idx, out_nidx,
//                         out_flat, out_nflat)        -> CSR faces
// Each returns 0 on success, negative error codes otherwise. Parsers
// accept the payload AFTER the FoamFile header (Python strips it), with
// comments allowed; they locate the leading "<count> (" themselves.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cerrno>

namespace {

struct Cursor {
    const char* p;
    const char* end;
};

// skip whitespace and // or /* */ comments
inline void skip_ws(Cursor& c) {
    while (c.p < c.end) {
        char ch = *c.p;
        if (ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r') {
            ++c.p;
        } else if (ch == '/' && c.p + 1 < c.end && c.p[1] == '/') {
            while (c.p < c.end && *c.p != '\n') ++c.p;
        } else if (ch == '/' && c.p + 1 < c.end && c.p[1] == '*') {
            c.p += 2;
            while (c.p + 1 < c.end && !(c.p[0] == '*' && c.p[1] == '/'))
                ++c.p;
            if (c.p + 1 < c.end) c.p += 2;
        } else {
            break;
        }
    }
}

inline bool parse_i64(Cursor& c, int64_t* out) {
    skip_ws(c);
    if (c.p >= c.end) return false;
    char* endp = nullptr;
    errno = 0;
    long long v = strtoll(c.p, &endp, 10);
    if (endp == c.p || errno == ERANGE) return false;
    c.p = endp;
    *out = (int64_t)v;
    return true;
}

inline bool parse_f64(Cursor& c, double* out) {
    skip_ws(c);
    if (c.p >= c.end) return false;
    char* endp = nullptr;
    errno = 0;
    double v = strtod(c.p, &endp);
    if (endp == c.p) return false;
    c.p = endp;
    *out = v;
    return true;
}

inline bool expect(Cursor& c, char ch) {
    skip_ws(c);
    if (c.p < c.end && *c.p == ch) { ++c.p; return true; }
    return false;
}

// Locate "<count>" then '(' and return count; cursor lands after '('.
inline bool list_header(Cursor& c, int64_t* count) {
    if (!parse_i64(c, count)) return false;
    return expect(c, '(');
}

}  // namespace

extern "C" {

void of_free(void* p) { free(p); }

// ---- labels (owner / neighbour) ----------------------------------------
int of_parse_labels_ascii(const char* buf, int64_t n_bytes,
                          int64_t** out_vals, int64_t* out_n) {
    Cursor c{buf, buf + n_bytes};
    int64_t n;
    if (!list_header(c, &n) || n < 0) return -1;
    int64_t* vals = (int64_t*)malloc(sizeof(int64_t) * (size_t)(n ? n : 1));
    if (!vals) return -2;
    for (int64_t i = 0; i < n; ++i) {
        if (!parse_i64(c, &vals[i])) { free(vals); return -3; }
    }
    if (!expect(c, ')')) { free(vals); return -4; }
    *out_vals = vals;
    *out_n = n;
    return 0;
}

// ---- points --------------------------------------------------------------
int of_parse_points_ascii(const char* buf, int64_t n_bytes,
                          double** out_vals, int64_t* out_n) {
    Cursor c{buf, buf + n_bytes};
    int64_t n;
    if (!list_header(c, &n) || n < 0) return -1;
    double* vals = (double*)malloc(sizeof(double) * (size_t)(3 * n ? 3 * n : 1));
    if (!vals) return -2;
    for (int64_t i = 0; i < n; ++i) {
        if (!expect(c, '(')) { free(vals); return -3; }
        for (int k = 0; k < 3; ++k) {
            if (!parse_f64(c, &vals[3 * i + k])) { free(vals); return -4; }
        }
        if (!expect(c, ')')) { free(vals); return -5; }
    }
    if (!expect(c, ')')) { free(vals); return -6; }
    *out_vals = vals;
    *out_n = n;
    return 0;
}

// ---- faces (ASCII "k(v0 v1 ... vk-1)" entries -> CSR) ----------------------
int of_parse_faces_ascii(const char* buf, int64_t n_bytes,
                         int64_t** out_idx, int64_t* out_nidx,
                         int64_t** out_flat, int64_t* out_nflat) {
    Cursor c{buf, buf + n_bytes};
    int64_t n;
    if (!list_header(c, &n) || n < 0) return -1;
    int64_t* idx = (int64_t*)malloc(sizeof(int64_t) * (size_t)(n + 1));
    if (!idx) return -2;
    size_t cap = (size_t)(n > 0 ? n * 4 : 4);
    int64_t* flat = (int64_t*)malloc(sizeof(int64_t) * cap);
    if (!flat) { free(idx); return -2; }
    size_t used = 0;
    idx[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t k;
        if (!parse_i64(c, &k) || k < 0 || !expect(c, '(')) {
            free(idx); free(flat); return -3;
        }
        if (used + (size_t)k > cap) {
            cap = (used + (size_t)k) * 2;
            int64_t* nf = (int64_t*)realloc(flat, sizeof(int64_t) * cap);
            if (!nf) { free(idx); free(flat); return -2; }
            flat = nf;
        }
        for (int64_t j = 0; j < k; ++j) {
            if (!parse_i64(c, &flat[used + (size_t)j])) {
                free(idx); free(flat); return -4;
            }
        }
        if (!expect(c, ')')) { free(idx); free(flat); return -5; }
        used += (size_t)k;
        idx[i + 1] = (int64_t)used;
    }
    if (!expect(c, ')')) { free(idx); free(flat); return -6; }
    *out_idx = idx;
    *out_nidx = n + 1;
    *out_flat = flat;
    *out_nflat = (int64_t)used;
    return 0;
}

}  // extern "C"
