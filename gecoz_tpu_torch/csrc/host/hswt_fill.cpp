// Single-pass Huffman-shaped wavelet tree fill.
//
// The port's copy of gecoz_tpu/native/hswt_fill.cpp (the same code).
//
// Re-creates the construction semantics of the reference's streaming fill
// (nova-algo tree/HuffmanShapedWaveletTree.java:127-146): every BWT byte
// appends one bit to each node along its Huffman code path.  The Python
// host build (index/hswt.py::HSWT.build) does this with per-node full-n
// masked passes; this kernel does the whole tree in ONE pass over the
// BWT, buffering each node's bits in a 64-bit accumulator so the hot
// loop is register-only until a word spills to the arena.
//
// Layout contract: `arena` is a zeroed byte buffer; node k's packed bits
// (LSB-first, identical to np.packbits(bitorder="little")) start at byte
// offset node_off[k].  Offsets are byte-aligned per node, so the Python
// side can slice the arena into per-node views with no copying.

#include <cstdint>
#include <cstring>

extern "C" {

void gecoz_hswt_fill(const uint8_t* bwt, int64_t n,
                     const int32_t* path_node,   // [256*64] node id/level
                     const uint8_t* path_bit,    // [256*64] code bit/level
                     const uint8_t* path_len,    // [256] code length
                     const int64_t* node_off,    // [K] arena byte offsets
                     int64_t nnodes,
                     uint8_t* arena) {
    // <=256 nodes by contract: a binary prefix code over bytes has at most
    // 255 internal nodes.  Guard the exported ABI against larger values,
    // which would overflow the fixed stack arrays below.
    if (n <= 0 || nnodes <= 0 || nnodes > 256) return;
    // per-node state: bit accumulator, bits buffered, next spill address
    uint64_t acc[256];
    int32_t cnt[256];
    uint8_t* dst[256];
    for (int64_t k = 0; k < nnodes; ++k) {
        acc[k] = 0;
        cnt[k] = 0;
        dst[k] = arena + node_off[k];
    }
    for (int64_t i = 0; i < n; ++i) {
        const int c = bwt[i];
        const int len = path_len[c];
        const int32_t* pn = path_node + (c << 6);
        const uint8_t* pb = path_bit + (c << 6);
        for (int j = 0; j < len; ++j) {
            const int32_t k = pn[j];
            acc[k] |= (uint64_t)pb[j] << cnt[k];
            if (++cnt[k] == 64) {
                std::memcpy(dst[k], &acc[k], 8);   // little-endian target
                dst[k] += 8;
                acc[k] = 0;
                cnt[k] = 0;
            }
        }
    }
    for (int64_t k = 0; k < nnodes; ++k) {
        if (cnt[k] > 0) {
            const int nb = (cnt[k] + 7) >> 3;
            std::memcpy(dst[k], &acc[k], nb);
        }
    }
}

}  // extern "C"
