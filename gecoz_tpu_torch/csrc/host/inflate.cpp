// Fast RFC 1951 inflate (C++ host tier).
//
// The port's copy of gecoz_tpu/native/inflate.cpp, built by
// gecoz_tpu_torch/kernels/_build.py::load_host with the other csrc/host
// sources into the port's host library.  One deliberate difference: a
// stream that ends before its final block does is refused (-4), where the
// reference reads zero bits past the end of its input and never finishes
// (ROADMAP C2).
//
// Native counterpart of gecoz_tpu_torch/codec/deflate.py::inflate — same
// semantics, table-driven: a 9-bit primary lookup with overflow sub-decode
// for longer codes, 64-bit bit buffer, and an overlap-safe window copy.
// Plays the role of the reference's hot decode loop (nova-algo deflate/
// Inflater.java) for gzipped FASTA input and BGZF members.
//
// Build: at first use (gecoz_tpu_torch/native.py), g++ -O3 -shared -fPIC

#include <cstdint>
#include <cstring>
#include <unistd.h>
#include <vector>

namespace {

struct BitIn {
  const uint8_t* data;
  int64_t size;
  int64_t pos = 0;      // byte position
  uint64_t acc = 0;
  int nbits = 0;

  void fill() {
    while (nbits <= 56 && pos < size) {
      acc |= (uint64_t)data[pos++] << nbits;
      nbits += 8;
    }
  }
  uint32_t read(int n) {
    if (nbits < n) fill();
    uint32_t v = (uint32_t)(acc & ((1u << n) - 1));
    acc >>= n;
    nbits -= n;
    return v;
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(acc & ((1u << n) - 1));
  }
  void skip(int n) { acc >>= n; nbits -= n; }
  void align() {
    int drop = nbits & 7;
    acc >>= drop;
    nbits -= drop;
  }
  // a read went past the end of the input: the stream was cut short
  // (fill() stops only at the end, so nbits < 0 happens only there)
  bool overrun() const { return nbits < 0; }
  int64_t bit_position() const { return pos * 8 - nbits; }
};

// canonical decode table: primary 10-bit direct lookup; codes longer than
// 10 bits resolved by linear extension (rare)
struct Huff {
  // primary entry: (symbol << 4) | nbits, 0 = invalid
  std::vector<uint16_t> primary;   // 1 << PBITS entries
  static const int PBITS = 10;
  uint32_t first_code[16] = {0};   // canonical first code per length
  int32_t count[16] = {0};
  int32_t offs[16] = {0};          // index of first symbol of length l
  std::vector<uint16_t> sorted_syms;
  int max_len = 0;

  bool build(const uint8_t* lens, int n) {
    std::memset(count, 0, sizeof(count));
    max_len = 0;
    for (int i = 0; i < n; ++i) {
      if (lens[i] > 15) return false;
      count[lens[i]]++;
    }
    count[0] = 0;
    uint32_t code = 0;
    int total = 0;
    for (int l = 1; l <= 15; ++l) {
      first_code[l] = code;
      offs[l] = total;
      code = (code + count[l]) << 1;
      total += count[l];
      if (count[l]) max_len = l;
    }
    sorted_syms.assign(total, 0);
    {
      int32_t pos[16];
      std::memcpy(pos, offs, sizeof(pos));
      for (int i = 0; i < n; ++i)
        if (lens[i]) sorted_syms[pos[lens[i]]++] = (uint16_t)i;
    }
    primary.assign(1 << PBITS, 0);
    for (int l = 1; l <= PBITS && l <= max_len; ++l) {
      uint32_t c = first_code[l];
      for (int k = 0; k < count[l]; ++k, ++c) {
        uint32_t rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((c >> b) & 1) << (l - 1 - b);
        uint16_t sym = sorted_syms[offs[l] + k];
        for (uint32_t j = rev; j < (1u << PBITS); j += 1u << l)
          primary[j] = (uint16_t)((sym << 4) | l);
      }
    }
    return total > 0;
  }

  int decode(BitIn& in) const {
    uint16_t e = primary[in.peek(PBITS)];
    if (e) {
      in.skip(e & 15);
      return e >> 4;
    }
    // long code: canonical MSB-first decode, continuing bit by bit
    uint32_t code = 0;
    for (int l = 1; l <= max_len; ++l) {
      code = (code << 1) | in.read(1);
      if ((int32_t)(code - first_code[l]) < count[l] &&
          code >= first_code[l]) {
        return sorted_syms[offs[l] + (code - first_code[l])];
      }
    }
    return -1;
  }
};

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

}  // namespace

extern "C" {

// Inflate one deflate stream.  Returns output size, or -1 on error, or -2
// if out_cap was insufficient, or -4 if the input ends inside the stream.
// *consumed_bits gets the bit position after the final block.
int64_t gecoz_inflate(const uint8_t* src, int64_t src_len,
                      uint8_t* out, int64_t out_cap,
                      int64_t* consumed_bits) {
  BitIn in{src, src_len};
  int64_t w = 0;
  for (;;) {
    uint32_t bfinal = in.read(1);
    uint32_t btype = in.read(2);
    if (in.overrun()) return -4;
    if (btype == 0) {
      in.align();
      uint32_t len = in.read(16);
      uint32_t nlen = in.read(16);
      if (in.overrun()) return -4;
      if ((len ^ 0xFFFF) != nlen) return -1;
      if (w + len > out_cap) return -2;
      for (uint32_t i = 0; i < len; ++i) out[w++] = (uint8_t)in.read(8);
      if (in.overrun()) return -4;
    } else if (btype == 1 || btype == 2) {
      Huff lit, dist;
      if (btype == 1) {
        uint8_t ll[288], dl[30];
        for (int i = 0; i < 144; ++i) ll[i] = 8;
        for (int i = 144; i < 256; ++i) ll[i] = 9;
        for (int i = 256; i < 280; ++i) ll[i] = 7;
        for (int i = 280; i < 288; ++i) ll[i] = 8;
        for (int i = 0; i < 30; ++i) dl[i] = 5;
        lit.build(ll, 288);
        dist.build(dl, 30);
      } else {
        uint32_t hlit = in.read(5) + 257;
        uint32_t hdist = in.read(5) + 1;
        uint32_t hclen = in.read(4) + 4;
        uint8_t cl[19] = {0};
        for (uint32_t i = 0; i < hclen; ++i) cl[CL_ORDER[i]] = (uint8_t)in.read(3);
        Huff clh;
        if (!clh.build(cl, 19)) return in.overrun() ? -4 : -1;
        std::vector<uint8_t> lens(hlit + hdist, 0);
        uint32_t i = 0;
        uint8_t prev = 0;
        while (i < hlit + hdist) {
          int sym = clh.decode(in);
          if (sym < 0) return in.overrun() ? -4 : -1;
          if (sym <= 15) { lens[i++] = prev = (uint8_t)sym; }
          else if (sym == 16) {
            uint32_t rep = in.read(2) + 3;
            while (rep-- && i < lens.size()) lens[i++] = prev;
          } else if (sym == 17) { i += in.read(3) + 3; prev = 0; }
          else { i += in.read(7) + 11; prev = 0; }
        }
        if (in.overrun()) return -4;
        if (!lit.build(lens.data(), hlit)) return -1;
        dist.build(lens.data() + hlit, hdist);
      }
      for (;;) {
        int sym = lit.decode(in);
        if (in.overrun()) return -4;
        if (sym < 0) return -1;
        if (sym < 256) {
          if (w >= out_cap) return -2;
          out[w++] = (uint8_t)sym;
        } else if (sym == 256) {
          break;
        } else {
          int li = sym - 257;
          if (li >= 29) return -1;
          uint32_t length = LEN_BASE[li] + in.read(LEN_EXTRA[li]);
          int ds = dist.decode(in);
          if (ds < 0 || ds >= 30) return in.overrun() ? -4 : -1;
          uint32_t d = DIST_BASE[ds] + in.read(DIST_EXTRA[ds]);
          if (in.overrun()) return -4;
          if ((int64_t)d > w) return -1;
          if (w + length > (uint64_t)out_cap) return -2;
          const uint8_t* s = out + w - d;
          // overlap-safe forward copy
          for (uint32_t i = 0; i < length; ++i) out[w + i] = s[i];
          w += length;
        }
      }
    } else {
      return -1;
    }
    if (bfinal) break;
  }
  if (consumed_bits) *consumed_bits = in.bit_position();
  return w;
}

// Streaming inflate: decoded bytes are written to `fd` as they are
// produced, holding only a ring-like buffer (32 KiB history + working
// room) — the native analog of the reference's windowed InflaterOutput
// (InflaterOutput.java's 32 KiB ring), so whole-file gzip members never
// materialize in memory.  Returns total output size, -1 on stream error,
// -3 on a write error, -4 if the input ends inside the stream.  *consumed_bits gets the bit position after the
// final block; *crc_out the CRC32 of the output (for the gzip footer).
int64_t gecoz_inflate_fd(const uint8_t* src, int64_t src_len, int fd,
                         int64_t* consumed_bits, uint32_t* crc_out);

namespace {

// CRC32 (IEEE, reflected) — small table, computed once
struct Crc32 {
  uint32_t table[256];
  Crc32() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  }
  uint32_t update(uint32_t crc, const uint8_t* p, int64_t n) const {
    crc = ~crc;
    for (int64_t i = 0; i < n; ++i)
      crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
  }
};
const Crc32 kCrc;

struct OutFd {
  int fd;
  std::vector<uint8_t> buf;
  int64_t w = 0;         // write position within buf
  int64_t total = 0;
  uint32_t crc = 0;
  bool err = false;

  explicit OutFd(int fd_) : fd(fd_), buf(1 << 20) {}

  void drain(int64_t keep) {
    int64_t out_n = w - keep;
    if (out_n <= 0) return;
    crc = kCrc.update(crc, buf.data(), out_n);
    int64_t done = 0;
    while (done < out_n) {
      ssize_t r = ::write(fd, buf.data() + done, (size_t)(out_n - done));
      if (r <= 0) { err = true; return; }
      done += r;
    }
    std::memmove(buf.data(), buf.data() + out_n, (size_t)keep);
    w = keep;
  }
  // ensure room for one more emit (max match 258); keep 32 KiB history
  void make_room() {
    if (w + 300 > (int64_t)buf.size()) drain(32768);
  }
  void put(uint8_t b) { buf[w++] = b; total++; }
};

}  // namespace

int64_t gecoz_inflate_fd(const uint8_t* src, int64_t src_len, int fd,
                         int64_t* consumed_bits, uint32_t* crc_out) {
  BitIn in{src, src_len};
  OutFd out(fd);
  for (;;) {
    uint32_t bfinal = in.read(1);
    uint32_t btype = in.read(2);
    if (in.overrun()) return -4;
    if (btype == 0) {
      in.align();
      uint32_t len = in.read(16);
      uint32_t nlen = in.read(16);
      if (in.overrun()) return -4;
      if ((len ^ 0xFFFF) != nlen) return -1;
      for (uint32_t i = 0; i < len; ++i) {
        out.make_room();
        if (out.err) return -3;
        out.put((uint8_t)in.read(8));
      }
      if (in.overrun()) return -4;
    } else if (btype == 1 || btype == 2) {
      Huff lit, dist;
      if (btype == 1) {
        uint8_t ll[288], dl[30];
        for (int i = 0; i < 144; ++i) ll[i] = 8;
        for (int i = 144; i < 256; ++i) ll[i] = 9;
        for (int i = 256; i < 280; ++i) ll[i] = 7;
        for (int i = 280; i < 288; ++i) ll[i] = 8;
        for (int i = 0; i < 30; ++i) dl[i] = 5;
        lit.build(ll, 288);
        dist.build(dl, 30);
      } else {
        uint32_t hlit = in.read(5) + 257;
        uint32_t hdist = in.read(5) + 1;
        uint32_t hclen = in.read(4) + 4;
        uint8_t cl[19] = {0};
        for (uint32_t i = 0; i < hclen; ++i)
          cl[CL_ORDER[i]] = (uint8_t)in.read(3);
        Huff clh;
        if (!clh.build(cl, 19)) return in.overrun() ? -4 : -1;
        std::vector<uint8_t> lens(hlit + hdist, 0);
        uint32_t i = 0;
        uint8_t prev = 0;
        while (i < hlit + hdist) {
          int sym = clh.decode(in);
          if (sym < 0) return in.overrun() ? -4 : -1;
          if (sym <= 15) { lens[i++] = prev = (uint8_t)sym; }
          else if (sym == 16) {
            uint32_t rep = in.read(2) + 3;
            while (rep-- && i < lens.size()) lens[i++] = prev;
          } else if (sym == 17) { i += in.read(3) + 3; prev = 0; }
          else { i += in.read(7) + 11; prev = 0; }
        }
        if (in.overrun()) return -4;
        if (!lit.build(lens.data(), hlit)) return -1;
        dist.build(lens.data() + hlit, hdist);
      }
      for (;;) {
        int sym = lit.decode(in);
        if (in.overrun()) return -4;
        if (sym < 0) return -1;
        if (sym < 256) {
          out.make_room();
          if (out.err) return -3;
          out.put((uint8_t)sym);
        } else if (sym == 256) {
          break;
        } else {
          int li = sym - 257;
          if (li >= 29) return -1;
          uint32_t length = LEN_BASE[li] + in.read(LEN_EXTRA[li]);
          int ds = dist.decode(in);
          if (ds < 0 || ds >= 30) return in.overrun() ? -4 : -1;
          uint32_t d = DIST_BASE[ds] + in.read(DIST_EXTRA[ds]);
          if (in.overrun()) return -4;
          if ((int64_t)d > out.total) return -1;
          out.make_room();
          if (out.err) return -3;
          if ((int64_t)d > out.w) return -1;   // history drained too far
          const uint8_t* s = out.buf.data() + out.w - d;
          uint8_t* dptr = out.buf.data() + out.w;
          for (uint32_t i = 0; i < length; ++i) dptr[i] = s[i];
          out.w += length;
          out.total += length;
        }
      }
    } else {
      return -1;
    }
    if (bfinal) break;
  }
  out.drain(0);
  if (out.err) return -3;
  if (consumed_bits) *consumed_bits = in.bit_position();
  if (crc_out) *crc_out = out.crc;
  return out.total;
}

}  // extern "C"
