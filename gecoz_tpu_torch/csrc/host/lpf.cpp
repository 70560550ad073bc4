// Exact longest-previous-factor over one deflate window.
//
// The port's copy of gecoz_tpu/native/lpf.cpp (the same code), built by
// gecoz_tpu_torch/kernels/_build.py::load_host with the other csrc/host
// sources into the port's host library.
//
// The reference's production match finder is suffix-array based (nova-algo
// deflate/LZ77.java: SAIS over the window + Kasai LCP + SA-neighbor
// scanning).  This kernel computes the strictly stronger exact LPF
// (Crochemore-Ilie): for text position p at SA rank r, the longest earlier
// occurrence is against PSV(r)/NSV(r) — the nearest ranks with a smaller
// text position — with length = range-min of LCP over the gap.
//
// Pipeline (all O(n) except the O(n log n) sparse table, n <= 64 KiB):
//   Kasai LCP -> monotonic-stack PSV/NSV over SA -> sparse-table RMQ ->
//   per-rank two O(1) range-min probes.
//
// Mirrors gecoz_tpu_torch/codec/deflate.py::_find_matches_sa, which remains the
// pure-python oracle (tests assert both agree).

#include <cstdint>
#include <vector>

namespace {

inline int32_t ilog2(int32_t x) {
    int32_t r = 0;
    while (x >> (r + 1)) ++r;
    return r;
}

}  // namespace

extern "C" {

// s: window bytes [n]; sa: its suffix array [n] (int32);
// out_len/out_dist: per-position match length (0 if < min_match) and
// backward distance.  max_match caps the reported length (deflate: 258).
void gecoz_lpf(const uint8_t* s, const int32_t* sa, int32_t n,
               int32_t min_match, int32_t max_match,
               int32_t* out_len, int32_t* out_dist) {
    if (n <= 0) return;
    for (int32_t i = 0; i < n; ++i) { out_len[i] = 0; out_dist[i] = 0; }

    // rank (inverse SA)
    std::vector<int32_t> rank(n);
    for (int32_t r = 0; r < n; ++r) rank[sa[r]] = r;

    // Kasai: lcp[r] = lcp(suffix sa[r], suffix sa[r-1])
    std::vector<int32_t> lcp(n, 0);
    int32_t h = 0;
    for (int32_t i = 0; i < n; ++i) {
        const int32_t r = rank[i];
        if (r > 0) {
            const int32_t j = sa[r - 1];
            const int32_t m = n - (i > j ? i : j);
            while (h < m && s[i + h] == s[j + h]) ++h;
            lcp[r] = h;
            if (h) --h;
        } else {
            h = 0;
        }
    }

    // sparse table over lcp
    const int32_t levels = n > 1 ? ilog2(n) + 1 : 1;
    std::vector<std::vector<int32_t>> table(levels);
    table[0] = lcp;
    for (int32_t k = 1; k < levels; ++k) {
        const int32_t half = 1 << (k - 1);
        const auto& prev = table[k - 1];
        const int32_t len = (int32_t)prev.size() - half;
        if (len <= 0) { table.resize(k); break; }
        table[k].resize(len);
        for (int32_t i = 0; i < len; ++i)
            table[k][i] = prev[i] < prev[i + half] ? prev[i] : prev[i + half];
    }
    auto range_min = [&](int32_t lo, int32_t hi) -> int32_t {  // inclusive
        if (lo > hi) return 0;
        const int32_t k = ilog2(hi - lo + 1);
        const auto& t = table[k];
        const int32_t a = t[lo], b = t[hi - (1 << k) + 1];
        return a < b ? a : b;
    };

    // PSV/NSV of text positions along SA order (monotonic stack)
    std::vector<int32_t> psv(n, -1), nsv(n, -1), stack;
    stack.reserve(64);
    for (int32_t r = 0; r < n; ++r) {
        while (!stack.empty() && sa[stack.back()] > sa[r]) {
            nsv[stack.back()] = r;
            stack.pop_back();
        }
        psv[r] = stack.empty() ? -1 : stack.back();
        stack.push_back(r);
    }

    for (int32_t r = 0; r < n; ++r) {
        const int32_t p = sa[r];
        int32_t best = 0, dist = 0;
        const int32_t rp = psv[r];
        if (rp >= 0) {
            const int32_t l = range_min(rp + 1, r);
            if (l > best) { best = l; dist = p - sa[rp]; }
        }
        const int32_t rn = nsv[r];
        if (rn >= 0) {
            const int32_t l = range_min(r + 1, rn);
            if (l > best) { best = l; dist = p - sa[rn]; }
        }
        if (best >= min_match) {
            out_len[p] = best < max_match ? best : max_match;
            out_dist[p] = dist;
        }
    }
}

}  // extern "C"
