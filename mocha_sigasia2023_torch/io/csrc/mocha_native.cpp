// Host codec of the port's BVH and database I/O, loaded with ctypes by
// mocha_sigasia2023_torch/io/native.py and built there with g++ at first use
// (ops/build.py).  Counterpart of the JAX package's native library: the same
// three entry points, the same results on the same bytes.
//
//   mocha_parse_floats   the MOTION block's float text -> doubles, strtod's
//                        longest prefix at every token
//   mocha_format_frames  an (nrows, ncols) matrix -> "%f " per value, "\n"
//                        per row
//   mocha_db_block_f32   one (u32 n0, u32 n1) + f32[n0 * n1 * ncomp] block
//                        of a database.bin copied out
//
// Each returns -1 when the caller's buffer cannot hold its result; the
// wrapper sizes every buffer so that this does not happen, and raises if it
// does.  This is host code: nothing here runs on the card.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// skipped between values
inline bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
           c == '\v';
}

// a token that strtod cannot start is skipped up to one of these: '\f' and
// '\v' do not end it
inline bool ends_token(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

}  // namespace

extern "C" {

// Parse text[0:len) into out (room for cap values); returns the count, or -1
// if out is full.  text[len] must be '\0': strtod reads up to it.  At each
// non-space byte strtod takes its longest prefix (sign, decimal or hex
// mantissa, exponent, inf, infinity, nan, nan(chars)) and parsing goes on
// from the end of that prefix, with no space needed before the next value;
// where no prefix parses, the token is skipped.
int64_t mocha_parse_floats(const char* text, int64_t len, double* out,
                           int64_t cap) {
    const char* p = text;
    const char* const end = text + len;
    int64_t n = 0;
    while (p < end) {
        if (is_space(*p)) {
            ++p;
            continue;
        }
        char* next = nullptr;
        const double v = strtod(p, &next);
        if (next == p) {
            while (p < end && !ends_token(*p)) ++p;
            continue;
        }
        if (n >= cap) return -1;
        out[n++] = v;
        p = next;
    }
    return n;
}

// Write vals (nrows x ncols, row-major) into out (cap bytes) as "%f " per
// value and "\n" per row; returns the bytes written (no terminator), or -1
// if they do not fit.
int64_t mocha_format_frames(const double* vals, int64_t nrows, int64_t ncols,
                            char* out, int64_t cap) {
    int64_t w = 0;
    for (int64_t r = 0; r < nrows; ++r) {
        const double* row = vals + r * ncols;
        for (int64_t c = 0; c < ncols; ++c) {
            // snprintf needs room for its terminator too
            const int k = snprintf(out + w, (size_t)(cap - w), "%f ", row[c]);
            if (k < 0 || k >= cap - w) return -1;
            w += k;
        }
        if (w >= cap) return -1;
        out[w++] = '\n';
    }
    return w;
}

// Copy the float32 block at buf[offset:] into out (room for cap floats) and
// its (n0, n1) into shape_out; returns the offset just past the block, or
// -1 if the block runs past buflen or does not fit in out.
int64_t mocha_db_block_f32(const uint8_t* buf, int64_t buflen, int64_t offset,
                           int64_t ncomp, float* out, int64_t cap,
                           int64_t* shape_out) {
    if (offset < 0 || ncomp < 0 || offset > buflen - 8) return -1;
    uint32_t n0, n1;
    memcpy(&n0, buf + offset, 4);
    memcpy(&n1, buf + offset + 4, 4);
    // n0 * n1 < 2^64 and (buflen - offset - 8) / 4 bounds the count, so
    // neither product below overflows once the first test passes
    const uint64_t cells = (uint64_t)n0 * n1;
    const uint64_t room = (uint64_t)(buflen - offset - 8) / 4;
    if (ncomp > 0 && cells > room / (uint64_t)ncomp) return -1;
    const int64_t count = (int64_t)(cells * (uint64_t)ncomp);
    if (count > cap) return -1;
    memcpy(out, buf + offset + 8, (size_t)count * 4);
    shape_out[0] = n0;
    shape_out[1] = n1;
    return offset + 8 + count * 4;
}

}  // extern "C"
