// Fast RFC 1951 deflate encoder (C++ host tier).
//
// The port's copy of gecoz_tpu/native/deflate_enc.cpp (the same code), built by
// gecoz_tpu_torch/kernels/_build.py::load_host with the other csrc/host
// sources into the port's host library.
//
// Native counterpart of gecoz_tpu_torch/codec/deflate.py::Deflater: greedy
// hash-chain LZ77 over a sliding 32 KiB window, one dynamic-Huffman block
// per 64 KiB of input, canonical length-limited codes.  Output bytes are
// an independent valid deflate stream (not byte-identical to the Python
// encoder, which is the semantic reference).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitOut {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;   // bytes written
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  void write(uint32_t bits, int n) {
    acc |= (uint64_t)(bits & ((1u << n) - 1)) << nbits;
    nbits += n;
    while (nbits >= 8) {
      if (pos >= cap) { overflow = true; nbits = 0; return; }
      out[pos++] = (uint8_t)acc;
      acc >>= 8;
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) {
      if (pos >= cap) { overflow = true; return; }
      out[pos++] = (uint8_t)acc;
      acc = 0;
      nbits = 0;
    }
  }
};

// Huffman code lengths, limited to max_bits, via count-sorted pairing
// (package-merge-free: build true Huffman depths then rebalance overlong)
void huff_lengths(const uint64_t* freq, int n, int max_bits, uint8_t* lens) {
  struct Node { uint64_t w; int l, r; };
  std::vector<Node> nodes;
  std::vector<int> heap;
  auto cmp = [&](int a, int b) { return nodes[a].w > nodes[b].w; };
  for (int i = 0; i < n; ++i)
    if (freq[i]) {
      nodes.push_back({freq[i], ~i, ~i});
      heap.push_back((int)nodes.size() - 1);
    }
  std::memset(lens, 0, n);
  if (heap.empty()) return;
  if (heap.size() == 1) { lens[~nodes[heap[0]].l] = 1; return; }
  std::make_heap(heap.begin(), heap.end(), cmp);
  while (heap.size() > 1) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    int a = heap.back(); heap.pop_back();
    std::pop_heap(heap.begin(), heap.end(), cmp);
    int b = heap.back(); heap.pop_back();
    nodes.push_back({nodes[a].w + nodes[b].w, a, b});
    heap.push_back((int)nodes.size() - 1);
    std::push_heap(heap.begin(), heap.end(), cmp);
  }
  // depth-assign iteratively
  std::vector<std::pair<int,int>> stack{{heap[0], 0}};
  int bl_count[64] = {0};
  while (!stack.empty()) {
    auto [v, d] = stack.back(); stack.pop_back();
    if (nodes[v].l < 0) {
      int depth = d ? d : 1;
      lens[~nodes[v].l] = (uint8_t)std::min(depth, 57);
      bl_count[std::min(depth, 57)]++;
    } else {
      stack.push_back({nodes[v].l, d + 1});
      stack.push_back({nodes[v].r, d + 1});
    }
  }
  // limit to max_bits (standard zlib-style rebalance)
  int overflow = 0;
  for (int d = max_bits + 1; d < 64; ++d) overflow += bl_count[d];
  if (overflow) {
    for (int i = 0; i < n; ++i)
      if (lens[i] > max_bits) lens[i] = (uint8_t)max_bits;
    // recompute counts
    int cnt[16] = {0};
    for (int i = 0; i < n; ++i) if (lens[i]) cnt[lens[i]]++;
    // Kraft fix: demote nodes until the sum fits
    int64_t kraft = 0;
    for (int d = 1; d <= max_bits; ++d)
      kraft += (int64_t)cnt[d] << (max_bits - d);
    while (kraft > (1ll << max_bits)) {
      // find a max_bits leaf and a shorter leaf to demote
      int d = max_bits - 1;
      while (d > 0 && cnt[d] == 0) --d;
      cnt[d]--; cnt[d + 1]++;
      kraft -= 1ll << (max_bits - d - 1);
    }
    // reassign lengths by frequency order (most frequent = shortest)
    std::vector<int> syms;
    for (int i = 0; i < n; ++i) if (freq[i]) syms.push_back(i);
    std::sort(syms.begin(), syms.end(),
              [&](int a, int b) { return freq[a] > freq[b]; });
    size_t k = 0;
    for (int d = 1; d <= max_bits; ++d)
      for (int c = 0; c < cnt[d] && k < syms.size(); ++c)
        lens[syms[k++]] = (uint8_t)d;
  }
}

void canonical_codes(const uint8_t* lens, int n, uint16_t* codes) {
  int cnt[16] = {0};
  for (int i = 0; i < n; ++i) cnt[lens[i]]++;
  cnt[0] = 0;
  uint32_t next[16] = {0};
  uint32_t code = 0;
  for (int d = 1; d <= 15; ++d) { next[d] = code = (code + cnt[d - 1]) << 1; }
  for (int i = 0; i < n; ++i) {
    int l = lens[i];
    if (!l) continue;
    uint32_t c = next[l]++;
    uint32_t rev = 0;
    for (int b = 0; b < l; ++b) rev |= ((c >> b) & 1) << (l - 1 - b);
    codes[i] = (uint16_t)rev;
  }
}

const uint16_t LEN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,35,
                               43,51,59,67,83,99,115,131,163,195,227,258};
const uint8_t LEN_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,
                               4,4,4,4,5,5,5,5,0};
const uint32_t DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,
                                257,385,513,769,1025,1537,2049,3073,4097,
                                6145,8193,12289,16385,24577};
const uint8_t DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,
                                9,9,10,10,11,11,12,12,13,13};
const uint8_t CL_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

int len_code(uint32_t l) {
  for (int i = 28; i >= 0; --i) if (l >= LEN_BASE[i]) return i;
  return 0;
}
int dist_code(uint32_t d) {
  for (int i = 29; i >= 0; --i) if (d >= DIST_BASE[i]) return i;
  return 0;
}

struct Token { uint32_t lit_or_len; uint32_t dist; };  // dist=0 -> literal

const int WBITS = 15;
const uint32_t WMASK = (1u << WBITS) - 1;  // 32 KiB window
const int HBITS = 16;

struct Tables {
  uint8_t lit_lens[288], dist_lens[30];
  uint16_t lit_codes[288], dist_codes[30];
};

void build_tables(const uint64_t* lit_freq, const uint64_t* dist_freq_in,
                  Tables& t) {
  uint64_t dist_freq[30];
  std::memcpy(dist_freq, dist_freq_in, sizeof dist_freq);
  huff_lengths(lit_freq, 288, 15, t.lit_lens);
  bool any_dist = false;
  for (int i = 0; i < 30; ++i) any_dist |= dist_freq[i] != 0;
  if (!any_dist) dist_freq[0] = 1;
  huff_lengths(dist_freq, 30, 15, t.dist_lens);
  canonical_codes(t.lit_lens, 288, t.lit_codes);
  canonical_codes(t.dist_lens, 30, t.dist_codes);
}

// dynamic header + token stream + end-of-block
void write_block(BitOut& bw, const Tables& t,
                 const std::vector<Token>& toks, bool last) {
  int hlit = 257, hdist = 1;
  for (int i = 287; i >= 257; --i) if (t.lit_lens[i]) { hlit = i + 1; break; }
  for (int i = 29; i >= 1; --i) if (t.dist_lens[i]) { hdist = i + 1; break; }

  std::vector<uint8_t> all(hlit + hdist);
  std::memcpy(all.data(), t.lit_lens, hlit);
  std::memcpy(all.data() + hlit, t.dist_lens, hdist);
  struct Op { uint8_t sym, extra, ebits; };
  std::vector<Op> ops;
  uint64_t cl_freq[19] = {0};
  for (size_t i = 0; i < all.size();) {
    uint8_t v = all[i];
    size_t j = i;
    while (j < all.size() && all[j] == v) ++j;
    size_t run = j - i;
    if (v == 0) {
      while (run >= 11) { size_t r = std::min<size_t>(run, 138);
        ops.push_back({18, (uint8_t)(r - 11), 7}); run -= r; }
      while (run >= 3) { size_t r = std::min<size_t>(run, 10);
        ops.push_back({17, (uint8_t)(r - 3), 3}); run -= r; }
      while (run--) ops.push_back({0, 0, 0});
    } else {
      ops.push_back({v, 0, 0});
      --run;
      while (run >= 3) { size_t r = std::min<size_t>(run, 6);
        ops.push_back({16, (uint8_t)(r - 3), 2}); run -= r; }
      while (run--) ops.push_back({v, 0, 0});
    }
    i = j;
  }
  for (auto& op : ops) cl_freq[op.sym]++;
  uint8_t cl_lens[19];
  uint16_t cl_codes[19];
  huff_lengths(cl_freq, 19, 7, cl_lens);
  canonical_codes(cl_lens, 19, cl_codes);
  int hclen = 4;
  for (int i = 18; i >= 4; --i)
    if (cl_lens[CL_ORDER[i]]) { hclen = i + 1; break; }

  bw.write(last ? 1 : 0, 1);
  bw.write(2, 2);
  bw.write(hlit - 257, 5);
  bw.write(hdist - 1, 5);
  bw.write(hclen - 4, 4);
  for (int i = 0; i < hclen; ++i) bw.write(cl_lens[CL_ORDER[i]], 3);
  for (auto& op : ops) {
    bw.write(cl_codes[op.sym], cl_lens[op.sym]);
    if (op.ebits) bw.write(op.extra, op.ebits);
  }
  for (auto& t_ : toks) {
    if (t_.dist == 0) {
      bw.write(t.lit_codes[t_.lit_or_len], t.lit_lens[t_.lit_or_len]);
    } else {
      int lc = len_code(t_.lit_or_len);
      bw.write(t.lit_codes[257 + lc], t.lit_lens[257 + lc]);
      bw.write(t_.lit_or_len - LEN_BASE[lc], LEN_EXTRA[lc]);
      int dc = dist_code(t_.dist);
      bw.write(t.dist_codes[dc], t.dist_lens[dc]);
      bw.write(t_.dist - DIST_BASE[dc], DIST_EXTRA[dc]);
    }
  }
  bw.write(t.lit_codes[256], t.lit_lens[256]);
}

}  // namespace

extern "C" {

// Deflate `src` into `out`; returns bytes written or -1 if cap exceeded.
int64_t gecoz_deflate(const uint8_t* src, int64_t n,
                      uint8_t* out, int64_t cap) {
  BitOut bw{out, cap};
  std::vector<int64_t> head(1 << HBITS, -1);
  std::vector<int64_t> prev(std::min<int64_t>(n, 1) << 0);
  prev.assign((size_t)std::max<int64_t>(n, 1), -1);

  auto hash3 = [&](int64_t i) {
    return ((uint32_t)src[i] * 506832829u ^ (uint32_t)src[i + 1] * 2654435761u
            ^ (uint32_t)src[i + 2] * 40503u) >> (32 - HBITS) & ((1u << HBITS) - 1);
  };

  const int64_t BLOCK = 64 * 1024;
  int64_t pos = 0;
  std::vector<Token> toks;
  toks.reserve(BLOCK);

  while (pos < n || n == 0) {
    int64_t block_end = std::min(n, pos + BLOCK);
    toks.clear();
    uint64_t lit_freq[288] = {0};
    uint64_t dist_freq[30] = {0};

    auto insert = [&](int64_t i) {
      if (i + 3 > n) return;
      uint32_t h = hash3(i);
      prev[i] = head[h];
      head[h] = i;
    };
    // search the chain WITHOUT inserting (callers insert explicitly so
    // the lazy peek at pos+1 can run before pos+1 is registered)
    auto find = [&](int64_t p, uint32_t& blen, uint32_t& bdist) {
      blen = 0;
      bdist = 0;
      if (p + 3 > n) return;
      int64_t cand = head[hash3(p)];
      int chain = 64;
      uint32_t max_match = (uint32_t)std::min<int64_t>(258, n - p);
      while (cand >= 0 && p - cand <= (int64_t)WMASK && chain--) {
        if (src[cand + blen] == src[p + blen]) {
          uint32_t l = 0;
          while (l < max_match && src[cand + l] == src[p + l]) ++l;
          if (l > blen) {
            blen = l;
            bdist = (uint32_t)(p - cand);
            if (l >= max_match) break;
          }
        }
        cand = prev[cand];
      }
    };

    while (pos < block_end) {
      uint32_t best_len, best_dist;
      find(pos, best_len, best_dist);
      insert(pos);
      if (best_len >= 3) {
        // lazy match: defer when the next position matches strictly longer
        if (pos + 1 < n) {
          uint32_t l2, d2;
          find(pos + 1, l2, d2);
          if (l2 > best_len) {
            lit_freq[src[pos]]++;
            toks.push_back({src[pos], 0});
            ++pos;
            continue;
          }
        }
        toks.push_back({best_len, best_dist});
        int lc = len_code(best_len), dc = dist_code(best_dist);
        lit_freq[257 + lc]++;
        dist_freq[dc]++;
        // insert hash entries for covered positions
        for (int64_t q = pos + 1; q < pos + best_len; ++q) insert(q);
        pos += best_len;
      } else {
        lit_freq[src[pos]]++;
        toks.push_back({src[pos], 0});
        ++pos;
      }
    }
    lit_freq[256]++;

    Tables t;
    build_tables(lit_freq, dist_freq, t);
    write_block(bw, t, toks, block_end >= n);
    if (bw.overflow) return -1;
    if (n == 0) break;
  }
  bw.flush();
  return bw.overflow ? -1 : bw.pos;
}

// from sais.cpp / lpf.cpp (all sources link into one libgecoz.so)
void gecoz_sais_u8(const uint8_t* s, int32_t n, int32_t* sa);
void gecoz_lpf(const uint8_t* s, const int32_t* sa, int32_t n,
               int32_t min_match, int32_t max_match,
               int32_t* out_len, int32_t* out_dist);

// SA-matcher deflate (the reference's PRODUCTION architecture,
// LZ77.java:26-180: suffix array over the window + LCP neighbor
// matching): exact LPF via gecoz_lpf, one-position lazy deferral (exact
// under LPF), and the reference Deflater's final-table gain re-check
// ("check if there is no gain", Deflater.java ~150-190) — matches whose
// dynamic-code cost meets their literal spelling are expanded back and
// the tables rebuilt.  Same block framing as gecoz_deflate: 64 KiB
// double window sliding 32 KiB, one dynamic block per window.
// Returns bytes written or -1 if cap exceeded.
int64_t gecoz_deflate_sa(const uint8_t* src, int64_t n,
                         uint8_t* out, int64_t cap) {
  BitOut bw{out, cap};
  const int64_t W = 32 * 1024;
  std::vector<int32_t> sa, mlen, mdist, rank;
  std::vector<Token> toks;

  for (int64_t off = 0; off < n || n == 0; off += W) {
    const int64_t hist = off >= W ? off - W : 0;
    const int64_t wn = std::min(n, off + W) - hist;   // <= 64 KiB
    const uint8_t* wp = src + hist;
    const int32_t start = (int32_t)(off - hist);

    toks.clear();
    uint64_t lit_freq[288] = {0};
    uint64_t dist_freq[30] = {0};

    if (wn > 0) {
      sa.resize(wn); mlen.resize(wn); mdist.resize(wn); rank.resize(wn);
      gecoz_sais_u8(wp, (int32_t)wn, sa.data());
      gecoz_lpf(wp, sa.data(), (int32_t)wn, 3,
                (int32_t)std::min<int64_t>(258, wn), mlen.data(),
                mdist.data());
      for (int32_t r = 0; r < (int32_t)wn; ++r) rank[sa[r]] = r;

      // deflate distances cap at 32 KiB; the exact-LPF neighbors are
      // nearest-by-POSITION, so a far match may hide a legal nearer
      // occurrence.  Recover it the reference's own way (LZ77.java SA
      // neighbor scan): walk a few ranks each side tracking the running
      // LCP minimum, keep the best candidate within the window.
      auto rescan = [&](int32_t p) {
        const int32_t r = rank[p];
        int32_t best = 0, bdist = 0;
        int32_t run = 1 << 30;
        for (int32_t q = r - 1; q >= 0 && q >= r - 48; --q) {
          // lcp between rank q and r shrinks monotonically
          int32_t step = 0;
          const uint8_t* a = wp + sa[q + 1];
          const uint8_t* b = wp + sa[q];
          int32_t lim = (int32_t)wn - std::max(sa[q + 1], sa[q]);
          while (step < lim && a[step] == b[step]) ++step;
          run = std::min(run, step);
          if (run < 3 || run <= best) break;
          int32_t d = p - sa[q];
          if (d > 0 && d <= (int32_t)WMASK && run > best) {
            best = run; bdist = d;
          }
        }
        int32_t run2 = 1 << 30;
        for (int32_t q = r + 1; q < (int32_t)wn && q <= r + 48; ++q) {
          int32_t step = 0;
          const uint8_t* a = wp + sa[q - 1];
          const uint8_t* b = wp + sa[q];
          int32_t lim = (int32_t)wn - std::max(sa[q - 1], sa[q]);
          while (step < lim && a[step] == b[step]) ++step;
          run2 = std::min(run2, step);
          if (run2 < 3 || run2 <= best) break;
          int32_t d = p - sa[q];
          if (d > 0 && d <= (int32_t)WMASK && run2 > best) {
            best = run2; bdist = d;
          }
        }
        mlen[p] = best >= 3 ? std::min(best, (int32_t)258) : 0;
        mdist[p] = bdist;
      };
      for (int32_t p = start; p < (int32_t)wn; ++p)
        if (mlen[p] >= 3 && mdist[p] > (int32_t)WMASK) rescan(p);

      // lazy tokenize (exact: mlen IS the longest previous factor)
      int32_t i = start;
      while (i < (int32_t)wn) {
        int32_t l = mlen[i];
        if (l >= 3) {
          if (i + 1 < (int32_t)wn && mlen[i + 1] > l) {
            lit_freq[wp[i]]++;
            toks.push_back({wp[i], 0});
            ++i;
            continue;
          }
          toks.push_back({(uint32_t)l, (uint32_t)mdist[i]});
          lit_freq[257 + len_code(l)]++;
          dist_freq[dist_code(mdist[i])]++;
          i += l;
        } else {
          lit_freq[wp[i]]++;
          toks.push_back({wp[i], 0});
          ++i;
        }
      }
    }
    lit_freq[256]++;

    Tables t;
    build_tables(lit_freq, dist_freq, t);

    // final-table gain re-check (Deflater.java ~150-190): with actual
    // code lengths known, expand matches that do not beat their bytes
    // spelled as literals, then rebuild the tables once.
    bool changed = false;
    {
      std::vector<Token> expanded;
      expanded.reserve(toks.size());
      int64_t pos = start;
      for (auto& tk : toks) {
        if (tk.dist == 0) {
          expanded.push_back(tk);
          ++pos;
          continue;
        }
        int lc = len_code(tk.lit_or_len), dc = dist_code(tk.dist);
        int mcost = t.lit_lens[257 + lc] + LEN_EXTRA[lc]
                  + t.dist_lens[dc] + DIST_EXTRA[dc];
        int lcost = 0;
        for (uint32_t k = 0; k < tk.lit_or_len; ++k) {
          int c = t.lit_lens[wp[pos + k]];
          lcost += c > 0 ? c : 15;          // unassigned -> pessimistic
        }
        if (lcost <= mcost) {
          for (uint32_t k = 0; k < tk.lit_or_len; ++k)
            expanded.push_back({wp[pos + k], 0});
          changed = true;
        } else {
          expanded.push_back(tk);
        }
        pos += tk.lit_or_len;
      }
      if (changed) {
        toks.swap(expanded);
        uint64_t lf[288] = {0}, df[30] = {0};
        for (auto& tk : toks) {
          if (tk.dist == 0) lf[tk.lit_or_len]++;
          else {
            lf[257 + len_code(tk.lit_or_len)]++;
            df[dist_code(tk.dist)]++;
          }
        }
        lf[256]++;
        build_tables(lf, df, t);
      }
    }

    write_block(bw, t, toks, off + W >= n);
    if (bw.overflow) return -1;
    if (n == 0) break;
  }
  bw.flush();
  return bw.overflow ? -1 : bw.pos;
}

}  // extern "C"
