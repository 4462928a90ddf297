// Raw snappy (the block format, not the framing format): the page codec of
// the port's Parquet reader and writer (data/storage/parquet_format.py).
//
// A stream is the uncompressed length as a little-endian base-128 varint,
// then elements, each a tag byte whose low two bits give its kind:
//   00 literal: length-1 in the upper six bits, or 60..63 there and the
//      length-1 in the next 1..4 bytes (little-endian), then the bytes;
//   01 copy-1: length 4..11 in bits 2..4, offset's high 3 bits in 5..7 and
//      its low 8 bits in the next byte;
//   10 copy-2: length-1 in the upper six bits, a 2-byte offset;
//   11 copy-4: length-1 in the upper six bits, a 4-byte offset.
// A copy repeats `length` bytes from `offset` bytes back in the output and
// may overlap what it writes.
//
// The decompressor checks every length and offset against both buffers and
// returns a negative code for a corrupt or truncated stream, which the
// binding raises. The compressor is greedy: per 64 KiB fragment, a hash
// table of 4-byte sequences gives one candidate a position, a match is
// extended as far as it goes, and what lies between matches is a literal.
//
// C ABI only, loaded with ctypes.

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kBlock = 1 << 16;
constexpr int kHashBits = 14;

enum : int64_t {
    kErrHeader = -1,     // no valid length varint
    kErrCapacity = -2,   // the declared length exceeds the output buffer
    kErrTruncated = -3,  // an element runs past the end of the input
    kErrOffset = -4,     // a copy's offset is 0 or reaches before the output
    kErrOverflow = -5,   // an element writes past the declared length
    kErrLength = -6,     // the elements end short of the declared length
};

inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash32(uint32_t v) { return (v * 0x1e35a7bdu) >> (32 - kHashBits); }

// the varint at in[0..n): its value, the bytes it took in *used; -1 if bad
int64_t read_varint(const uint8_t* in, int64_t n, int64_t* used) {
    uint64_t v = 0;
    for (int i = 0; i < 5 && i < n; ++i) {
        v |= static_cast<uint64_t>(in[i] & 0x7f) << (7 * i);
        if (!(in[i] & 0x80)) {
            if (v > 0xffffffffull) return -1;
            *used = i + 1;
            return static_cast<int64_t>(v);
        }
    }
    return -1;
}

uint8_t* put_literal(uint8_t* op, const uint8_t* src, int64_t len) {
    int64_t n = len - 1;
    if (n < 60) {
        *op++ = static_cast<uint8_t>(n << 2);
    } else {
        int bytes = n < (1 << 8) ? 1 : n < (1 << 16) ? 2 : n < (1 << 24) ? 3 : 4;
        *op++ = static_cast<uint8_t>((59 + bytes) << 2);
        for (int i = 0; i < bytes; ++i) *op++ = static_cast<uint8_t>(n >> (8 * i));
    }
    std::memcpy(op, src, len);
    return op + len;
}

uint8_t* put_copy_one(uint8_t* op, int64_t offset, int64_t len) {
    if (len <= 11 && offset < 2048) {  // len >= 4 always holds here
        *op++ = static_cast<uint8_t>(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
        *op++ = static_cast<uint8_t>(offset & 0xff);
    } else {
        *op++ = static_cast<uint8_t>(2 | ((len - 1) << 2));
        *op++ = static_cast<uint8_t>(offset & 0xff);
        *op++ = static_cast<uint8_t>(offset >> 8);
    }
    return op;
}

uint8_t* put_copy(uint8_t* op, int64_t offset, int64_t len) {
    // a copy-2 carries at most 64 bytes; keep every remainder at >= 4
    while (len >= 68) {
        op = put_copy_one(op, offset, 64);
        len -= 64;
    }
    if (len > 64) {
        op = put_copy_one(op, offset, 60);
        len -= 60;
    }
    return put_copy_one(op, offset, len);
}

uint8_t* compress_fragment(const uint8_t* in, int64_t n, uint8_t* op, uint16_t* table) {
    std::memset(table, 0, sizeof(uint16_t) << kHashBits);
    int64_t lit = 0, i = 1;  // position 0 seeds the table
    if (n >= 4) table[hash32(load32(in))] = 0;
    int64_t misses = 0;
    while (i + 4 <= n) {
        uint32_t cur = load32(in + i);
        uint32_t h = hash32(cur);
        int64_t cand = table[h];
        table[h] = static_cast<uint16_t>(i);
        if (cand < i && load32(in + cand) == cur) {
            int64_t len = 4;
            while (i + len < n && in[cand + len] == in[i + len]) ++len;
            if (i > lit) op = put_literal(op, in + lit, i - lit);
            op = put_copy(op, i - cand, len);
            i += len;
            lit = i;
            misses = 0;
            if (i + 4 <= n && i >= 1) table[hash32(load32(in + i - 1))] =
                static_cast<uint16_t>(i - 1);
        } else {
            // skip faster through data that does not compress
            i += 1 + (misses++ >> 5);
        }
    }
    if (n > lit) op = put_literal(op, in + lit, n - lit);
    return op;
}

}  // namespace

extern "C" {

// an upper bound of the compressed size of n input bytes
int64_t pio_snappy_max_compressed_length(int64_t n) { return 32 + n + n / 6; }

// compress in[0..n) into out[0..cap): the compressed size, or -2 if cap is
// below pio_snappy_max_compressed_length(n)
int64_t pio_snappy_compress(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    if (n < 0 || n > 0xffffffffll || cap < pio_snappy_max_compressed_length(n)) return kErrCapacity;
    uint8_t* op = out;
    uint64_t v = static_cast<uint64_t>(n);
    do {
        uint8_t b = v & 0x7f;
        v >>= 7;
        *op++ = b | (v ? 0x80 : 0);
    } while (v);
    static thread_local uint16_t table[1 << kHashBits];
    for (int64_t at = 0; at < n; at += kBlock) {
        int64_t len = n - at < kBlock ? n - at : kBlock;
        op = compress_fragment(in + at, len, op, table);
    }
    return op - out;
}

// the length a stream declares, or a negative code
int64_t pio_snappy_uncompressed_length(const uint8_t* in, int64_t n) {
    int64_t used = 0;
    int64_t v = read_varint(in, n, &used);
    return v < 0 ? kErrHeader : v;
}

// decompress in[0..n) into out[0..cap): the bytes written (the declared
// length), or a negative code for a corrupt or truncated stream
int64_t pio_snappy_decompress(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    int64_t used = 0;
    int64_t want = read_varint(in, n, &used);
    if (want < 0) return kErrHeader;
    if (want > cap) return kErrCapacity;
    const uint8_t* ip = in + used;
    const uint8_t* end = in + n;
    int64_t o = 0;
    while (ip < end) {
        uint8_t tag = *ip++;
        int64_t len, off;
        switch (tag & 3) {
            case 0: {
                len = (tag >> 2) + 1;
                if (len > 60) {
                    int bytes = static_cast<int>(len - 60);
                    if (end - ip < bytes) return kErrTruncated;
                    uint64_t l = 0;
                    for (int i = 0; i < bytes; ++i) l |= static_cast<uint64_t>(ip[i]) << (8 * i);
                    ip += bytes;
                    len = static_cast<int64_t>(l) + 1;
                }
                if (end - ip < len) return kErrTruncated;
                if (want - o < len) return kErrOverflow;
                std::memcpy(out + o, ip, len);
                ip += len;
                o += len;
                continue;
            }
            case 1:
                if (end - ip < 1) return kErrTruncated;
                len = 4 + ((tag >> 2) & 7);
                off = (static_cast<int64_t>(tag >> 5) << 8) | ip[0];
                ip += 1;
                break;
            case 2:
                if (end - ip < 2) return kErrTruncated;
                len = (tag >> 2) + 1;
                off = ip[0] | (static_cast<int64_t>(ip[1]) << 8);
                ip += 2;
                break;
            default:
                if (end - ip < 4) return kErrTruncated;
                len = (tag >> 2) + 1;
                off = static_cast<int64_t>(load32(ip));
                ip += 4;
                break;
        }
        if (off == 0 || off > o) return kErrOffset;
        if (want - o < len) return kErrOverflow;
        uint8_t* dst = out + o;
        const uint8_t* src = dst - off;
        if (off >= len) {
            std::memcpy(dst, src, len);
        } else {
            for (int64_t k = 0; k < len; ++k) dst[k] = src[k];
        }
        o += len;
    }
    return o == want ? want : kErrLength;
}

}  // extern "C"
