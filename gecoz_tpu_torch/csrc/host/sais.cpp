// SA-IS suffix array construction (linear time) + gecoz layout helpers.
//
// The port's copy of gecoz_tpu/native/sais.cpp (the same code), built by
// gecoz_tpu_torch/kernels/_build.py::load_host with hswt_fill.cpp into the
// port's host library.
//
// Host-side native tier of gecoz-tpu: plays the role the reference's Java
// kernels play (nova-algo string/SAIS.java — an SA-IS/SACA-K hybrid with a
// 5n working-memory contract, SAIS.java:39-41, README.md:41).  This is an
// independent MEMORY-LEAN SA-IS implementation (Nong, Zhang & Chan, DCC
// 2009): classify L/S types, sort LMS substrings by induced sorting, name
// them, recurse on the reduced string if names repeat, then induce the
// final order.  Output equals the true lexicographic suffix array,
// matching the numpy/JAX backends bit-for-bit.
//
// Memory discipline (matching the reference's 5n contract): besides the
// input (n bytes) and the output SA (4n bytes), per level the only O(n)
// scratch is the PACKED type-bit array (n/8 bytes; levels sum to n/4).
// The sorted-LMS list, the LMS-substring names, the reduced string, and
// the recursive SA all live INSIDE the output SA (names keyed by
// position>>1 fit the second half because LMS positions are never
// adjacent; reduced string compacts right-to-left into the tail; the
// recursion writes its SA into the head — the regions never overlap
// because nlms <= n/2).  Bucket arrays are 8*sigma bytes per level:
// 2 KiB at the byte level; at recursion levels sigma = #names, which for
// real text is far below n (adversarial worst case adds <= 4n transient).
//
// Build: at first use (gecoz_tpu_torch/native.py), g++ -O3 -shared -fPIC

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Generic over the text type: uint8 at the top level, int32 for recursion.
template <typename T>
void sais(const T* s, int32_t* sa, int32_t n, int32_t sigma) {
  if (n == 0) return;
  if (n == 1) { sa[0] = 0; return; }

  // -- packed S/L type bits (the only O(n) scratch) -------------------------
  std::vector<uint8_t> tb((n + 7) >> 3, 0);
  auto set_s = [&](int32_t i) { tb[i >> 3] |= (uint8_t)(1u << (i & 7)); };
  auto is_s = [&](int32_t i) -> bool {
    return (tb[i >> 3] >> (i & 7)) & 1;
  };
  // the virtual sentinel is smaller than every symbol, so the last suffix
  // is L-type, and equal runs ending at the boundary inherit L
  for (int32_t i = n - 2; i >= 0; --i)
    if (s[i] < s[i + 1] || (s[i] == s[i + 1] && is_s(i + 1))) set_s(i);
  auto is_lms = [&](int32_t i) {
    return i > 0 && is_s(i) && !is_s(i - 1);
  };

  // -- buckets ---------------------------------------------------------------
  std::vector<int32_t> bucket(sigma, 0), bptr(sigma);
  for (int32_t i = 0; i < n; ++i) bucket[s[i]]++;
  auto reset_ends = [&]() {
    int32_t sum = 0;
    for (int32_t c = 0; c < sigma; ++c) { sum += bucket[c]; bptr[c] = sum; }
  };
  auto reset_starts = [&]() {
    int32_t sum = 0;
    for (int32_t c = 0; c < sigma; ++c) { bptr[c] = sum; sum += bucket[c]; }
  };

  // Induce passes are memory-latency-bound: sa[i] is read sequentially
  // but s[j-1] / the type bit / the bucket slot are all random.  Software
  // prefetch of the next few iterations' dependent lines overlaps those
  // misses (entries PD ahead may still be unwritten — that only wastes a
  // prefetch, never correctness, since j is re-read at its own iteration).
  constexpr int32_t PD = 12;
  auto induce = [&]() {
    // L-type left-to-right (suffix n-1 has no successor: seed if L-type)
    reset_starts();
    if (!is_s(n - 1)) sa[bptr[s[n - 1]]++] = n - 1;
    for (int32_t i = 0; i < n; ++i) {
      if (i + PD < n) {
        int32_t pj = sa[i + PD];
        if (pj > 0) {
          __builtin_prefetch(&s[pj - 1]);
          __builtin_prefetch(&tb[(pj - 1) >> 3]);
        }
      }
      if (i + PD / 2 < n) {
        // half-distance second stage: by now s[pj-1] is resident, so the
        // bucket slot (the random WRITE target) can be prefetched too
        int32_t pj = sa[i + PD / 2];
        if (pj > 0) __builtin_prefetch(&sa[bptr[s[pj - 1]]], 1);
      }
      int32_t j = sa[i];
      if (j > 0 && !is_s(j - 1)) sa[bptr[s[j - 1]]++] = j - 1;
    }
    // S-type right-to-left
    reset_ends();
    for (int32_t i = n - 1; i >= 0; --i) {
      if (i - PD >= 0) {
        int32_t pj = sa[i - PD];
        if (pj > 0) {
          __builtin_prefetch(&s[pj - 1]);
          __builtin_prefetch(&tb[(pj - 1) >> 3]);
        }
      }
      if (i - PD / 2 >= 0) {
        int32_t pj = sa[i - PD / 2];
        if (pj > 0) __builtin_prefetch(&sa[bptr[s[pj - 1]] - 1], 1);
      }
      int32_t j = sa[i];
      if (j > 0 && is_s(j - 1)) sa[--bptr[s[j - 1]]] = j - 1;
    }
  };

  // ---- stage 1: sort LMS suffixes approximately (by LMS substring)
  std::memset(sa, -1, sizeof(int32_t) * (size_t)n);
  reset_ends();
  for (int32_t i = n - 1; i >= 1; --i)
    if (is_lms(i)) sa[--bptr[s[i]]] = i;
  induce();

  // ---- stage 2: compact the sorted LMS positions into sa[0:nlms]
  int32_t nlms = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t j = sa[i];
    if (j > 0 && is_s(j) && !is_s(j - 1)) sa[nlms++] = j;
  }
  if (nlms == 0) {
    // no LMS: a run of S-type suffixes at position 0 (never LMS) and then
    // a non-increasing L-type tail.  The virtual sentinel is the only LMS
    // suffix: the L pass places the tail, the S pass the run.  (The
    // reference's copy runs the L pass alone and leaves the run's slots
    // at -1: ROADMAP C6.)
    std::memset(sa, -1, sizeof(int32_t) * (size_t)n);
    induce();
    return;
  }

  // name LMS substrings in sorted order; names keyed by position>>1 live
  // in sa[nlms:] (LMS positions are never adjacent, so >>1 is injective;
  // nlms + ceil(n/2) <= n always)
  int32_t nh = (n + 1) >> 1;
  int32_t* names = sa + nlms;
  std::memset(names, -1, sizeof(int32_t) * (size_t)nh);
  int32_t last_name = -1, prev = -1;
  for (int32_t k = 0; k < nlms; ++k) {
    int32_t j = sa[k];
    if (prev < 0) {
      last_name = 0;
    } else {
      // compare LMS substrings at prev and j (inclusive of next LMS char)
      bool diff = false;
      for (int32_t d = 0;; ++d) {
        int32_t a = prev + d, b = j + d;
        if (a >= n || b >= n) { diff = (a >= n) != (b >= n); break; }
        if (s[a] != s[b] || is_s(a) != is_s(b)) { diff = true; break; }
        if (d > 0 && (is_lms(a) || is_lms(b))) {
          diff = !(is_lms(a) && is_lms(b));
          break;
        }
      }
      if (diff) ++last_name;
    }
    names[j >> 1] = last_name;
    prev = j;
  }
  int32_t num_names = last_name + 1;

  // reduced string (names in text order): compact the sparse names area
  // right-to-left into the tail of sa — destination never passes source
  int32_t* s1 = sa + n - nlms;
  for (int32_t i = nh - 1, w = nlms - 1; i >= 0; --i)
    if (names[i] >= 0) s1[w--] = names[i];

  // recursive SA of the reduced string goes into sa[0:nlms] (disjoint
  // from s1: 2*nlms <= n)
  if (num_names < nlms) {
    sais<int32_t>(s1, sa, nlms, num_names);
  } else {
    for (int32_t k = 0; k < nlms; ++k) sa[s1[k]] = k;
  }

  // get back LMS positions: rebuild the text-order list in the tail
  // (overwriting s1, which is consumed), then map the reduced SA in place
  for (int32_t i = 1, w = 0; i < n; ++i)
    if (is_lms(i)) s1[w++] = i;
  for (int32_t k = 0; k < nlms; ++k) sa[k] = s1[sa[k]];

  // ---- stage 3: induce the final order from sorted LMS suffixes
  std::memset(sa + nlms, -1, sizeof(int32_t) * (size_t)(n - nlms));
  reset_ends();
  for (int32_t k = nlms - 1; k >= 0; --k) {
    int32_t j = sa[k];
    sa[k] = -1;
    sa[--bptr[s[j]]] = j;      // target >= k: sorted LMS land at final spots
  }
  induce();
}

}  // namespace

extern "C" {

// True suffix array of a byte string; sa must hold n int32s.
void gecoz_sais_u8(const uint8_t* s, int32_t n, int32_t* sa) {
  sais<uint8_t>(s, sa, n, 256);
}

// BWT gather: bwt[i] = s[(sa[i]+n-1) mod n].
void gecoz_bwt(const uint8_t* s, const int32_t* sa, int32_t n, uint8_t* bwt) {
  for (int32_t i = 0; i < n; ++i) {
    int32_t j = sa[i];
    bwt[i] = s[j == 0 ? n - 1 : j - 1];
  }
}

// Interleave packed bit data with gecoz rank counters
// (RankedWTNode layout; see gecoz_tpu_torch/index/rankbv.py).
// data: (len_bits+7)/8 bytes; out: rbv_bytes(len_bits) bytes.
void gecoz_interleave_rbv(const uint8_t* data, int64_t len_bits,
                          uint8_t* out) {
  int64_t nbytes = (len_bits + 7) >> 3;
  int64_t nboundaries = (len_bits - 1) >> 9;
  int64_t ngroups = nboundaries + 1;
  uint64_t abs_rank = 0, seg_rank = 0;
  int64_t out_pos = 0;
  for (int64_t g = 0; g < ngroups; ++g) {
    if (g > 0) {
      if ((g & 127) == 0) {
        std::memcpy(out + out_pos, &abs_rank, 8);
        out_pos += 8;
        seg_rank = 0;
      } else {
        uint16_t v = (uint16_t)seg_rank;
        std::memcpy(out + out_pos, &v, 2);
        out_pos += 2;
      }
    }
    int64_t start = g * 64;
    int64_t m = nbytes - start < 64 ? nbytes - start : 64;
    std::memcpy(out + out_pos, data + start, m);
    out_pos += m;
    // popcount this group
    uint64_t cnt = 0;
    for (int64_t b = 0; b < m; ++b)
      cnt += __builtin_popcount(data[start + b]);
    abs_rank += cnt;
    seg_rank += cnt;
  }
}

void gecoz_deinterleave_rbv(const uint8_t* buf, int64_t len_bits,
                            uint8_t* data) {
  int64_t nbytes = (len_bits + 7) >> 3;
  int64_t nboundaries = (len_bits - 1) >> 9;
  int64_t ngroups = nboundaries + 1;
  int64_t in_pos = 0;
  for (int64_t g = 0; g < ngroups; ++g) {
    if (g > 0) in_pos += ((g & 127) == 0) ? 8 : 2;
    int64_t start = g * 64;
    int64_t m = nbytes - start < 64 ? nbytes - start : 64;
    std::memcpy(data + start, buf + in_pos, m);
    in_pos += m;
  }
}

}  // extern "C"

extern "C" {

// Corrected LF table in int32 (block length is capped at 2^31 by the
// int32-SA contract, SAIS.java:103): LF(i) = c[bwt[i]] + rank, with the
// separator wrap-row fix documented in gecoz_tpu/index/fm.py.
void gecoz_lf_build(const uint8_t* bwt, int64_t n, int64_t wrap_row,
                    int32_t* lf) {
  std::vector<int64_t> c(257, 0);
  for (int64_t i = 0; i < n; ++i) c[bwt[i] + 1]++;
  for (int i = 0; i < 256; ++i) c[i + 1] += c[i];
  std::vector<int64_t> seen(256, 0);
  int64_t zero_rank = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t s = bwt[i];
    if (s == 0) {
      lf[i] = (int32_t)(1 + zero_rank - (wrap_row < i ? 1 : 0));
      zero_rank++;
    } else {
      lf[i] = (int32_t)(c[s] + seen[s]++);
    }
  }
  if (wrap_row >= 0 && wrap_row < n) lf[wrap_row] = 0;
}

// Decode walks [w0, w1) of the per-sampling-interval schedule with a
// prebuilt LF table (gecoz_lf_build).  Walk w emits global positions
// [w*rate, min((w+1)*rate, n-1)); seeds[w-w0] is the BWT row whose SA
// value is min((w+1)*rate, n-1) (a partial final walk passes row 0, whose
// SA value is n-1, optionally pre-advanced by tail_rewind LF steps).
// `text` is chunk-local: text[pos - w0*rate].  Thread-safe over disjoint
// walk ranges (bwt/lf are read-only), which is what the parallel decode
// pipeline exploits (GecoRead.java:83-175's pool, re-cast as chunk
// workers over one shared table).
void gecoz_fm_decode_walks(const uint8_t* bwt, int64_t n, const int32_t* lf,
                           const int64_t* seeds, int64_t w0, int64_t w1,
                           int64_t rate, int64_t tail_rewind, uint8_t* text) {
  int64_t base = w0 * rate;
  for (int64_t w = w0; w < w1; ++w) {
    int64_t hi = (w + 1) * rate;             // exclusive top position
    if (hi > n - 1) hi = n - 1;              // tail walk
    int64_t lo = w * rate;
    int64_t idx = seeds[w - w0];
    if (w == w1 - 1 && tail_rewind)
      for (int64_t p = 0; p < tail_rewind; ++p) idx = lf[idx];
    for (int64_t pos = hi - 1; pos >= lo; --pos) {
      text[pos - base] = bwt[idx];
      idx = lf[idx];
    }
  }
}

// Full-text FM decode (single call): builds the LF table then runs every
// walk.  Kept for the one-shot path; the chunked pipeline uses
// gecoz_lf_build + gecoz_fm_decode_walks directly.
void gecoz_fm_decode(const uint8_t* bwt, int64_t n, int64_t wrap_row,
                     const int64_t* seeds, int64_t nwalks, int64_t rate,
                     int64_t tail_rewind, uint8_t* text) {
  std::vector<int32_t> lf(n);
  gecoz_lf_build(bwt, n, wrap_row, lf.data());
  gecoz_fm_decode_walks(bwt, n, lf.data(), seeds, 0, nwalks, rate,
                        tail_rewind, text);
}

}  // extern "C"

extern "C" {

// Wavelet-node partition: element i of the node carries positions[i]; its
// bit routes it to the left (0) or right (1) child, preserving order.
// Returns the number of left elements; rights are written to out_right.
int64_t gecoz_wt_partition(const uint8_t* bits, const int32_t* positions,
                           int64_t npos, int32_t* out_left,
                           int32_t* out_right) {
  int64_t nl = 0, nr = 0;
  for (int64_t i = 0; i < npos; ++i) {
    if ((bits[i >> 3] >> (i & 7)) & 1)
      out_right[nr++] = positions[i];
    else
      out_left[nl++] = positions[i];
  }
  return nl;
}

}  // extern "C"
