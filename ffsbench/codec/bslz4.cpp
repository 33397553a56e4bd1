// Bitshuffle-LZ4 encoder of the benchmark (HDF5 filter 32008 framing, as the
// Eiger stream writes each image): a frozen copy of the spotfinder's own test
// encoder, kept here so that the frames the benchmark feeds the program do
// not move when the program's codec changes.
//
// Framing: a 12-byte header (uint64 big-endian decoded bytes, uint32
// big-endian block bytes), then per block of `block_elem` elements a
// big-endian uint32 compressed length and an LZ4 block of the bitshuffled
// bytes; the last n_elem % 8 elements follow raw.
//
// Plain C ABI for ctypes; no global state (the hash table is thread-local), so
// several threads may encode at once.

#include <cstdint>
#include <cstring>

extern "C" {

// Greedy LZ4 block compressor (hash-chain-free; correctness-oriented, used
// for round-trip tests and the SHM writer test fixture).
long long ffsbench_lz4_compress_block(const uint8_t* src,
                                 long long src_len,
                                 uint8_t* dst,
                                 long long dst_capacity) {
    // Simple 16-bit rolling hash table of last positions.
    const int HASH_BITS = 16;
    const size_t HASH_SIZE = 1u << HASH_BITS;
    static thread_local int64_t table[1u << 16];
    for (size_t i = 0; i < HASH_SIZE; ++i) table[i] = -1;

    auto hash = [](const uint8_t* p) -> uint32_t {
        uint32_t v;
        std::memcpy(&v, p, 4);
        return (v * 2654435761u) >> (32 - 16);
    };

    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    const uint8_t* anchor = src;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_capacity;

    auto emit = [&](size_t lit_len, size_t match_len, size_t offset) -> bool {
        // token
        if (op + 1 >= oend) return false;
        uint8_t* token = op++;
        size_t ll = lit_len, ml = match_len ? match_len - 4 : 0;
        *token = static_cast<uint8_t>((ll >= 15 ? 15 : ll) << 4 | (match_len ? (ml >= 15 ? 15 : ml) : 0));
        if (ll >= 15) {
            ll -= 15;
            while (ll >= 255) { if (op >= oend) return false; *op++ = 255; ll -= 255; }
            if (op >= oend) return false;
            *op++ = static_cast<uint8_t>(ll);
        }
        if (op + lit_len > oend) return false;
        std::memcpy(op, anchor, lit_len);
        op += lit_len;
        if (match_len) {
            if (op + 2 > oend) return false;
            *op++ = static_cast<uint8_t>(offset & 0xFF);
            *op++ = static_cast<uint8_t>(offset >> 8);
            if (ml >= 15) {
                ml -= 15;
                while (ml >= 255) { if (op >= oend) return false; *op++ = 255; ml -= 255; }
                if (op >= oend) return false;
                *op++ = static_cast<uint8_t>(ml);
            }
        }
        return true;
    };

    // LZ4 spec: last match must start at least 12 bytes before end; last 5
    // bytes are always literals.
    const uint8_t* mflimit = iend - 12;
    while (ip < mflimit) {
        if (iend - ip >= 4) {
            uint32_t h = hash(ip);
            int64_t cand = table[h];
            table[h] = ip - src;
            if (cand >= 0 && (ip - src) - cand <= 65535
                && std::memcmp(src + cand, ip, 4) == 0) {
                // extend match
                const uint8_t* m = src + cand;
                size_t match_len = 4;
                while (ip + match_len < iend - 5 && m[match_len] == ip[match_len])
                    ++match_len;
                if (!emit(ip - anchor, match_len, ip - m)) return -1;
                ip += match_len;
                anchor = ip;
                continue;
            }
        }
        ++ip;
    }
    // trailing literals
    if (!emit(iend - anchor, 0, 0)) return -1;
    return static_cast<long long>(op - dst);
}


static void bshuf_transpose_block(const uint8_t* in,
                                  uint8_t* out,
                                  size_t n,
                                  size_t elem_size) {
    const size_t nb = n / 8;
    for (size_t j = 0; j < elem_size; ++j) {
        uint8_t* rows = out + j * n;
        for (size_t m = 0; m < nb; ++m) {
            for (size_t kk = 0; kk < 8; ++kk) {
                const uint8_t bit = static_cast<uint8_t>(kk);
                uint8_t r = 0;
                for (size_t t = 0; t < 8; ++t) {
                    r |= static_cast<uint8_t>(
                        ((in[(8 * m + t) * elem_size + j] >> bit) & 1u) << t);
                }
                rows[kk * nb + m] = r;
            }
        }
    }
}


int ffsbench_bitshuffle_encode(const uint8_t* in, uint8_t* out, long long n_elem,
                          long long elem_size) {
    const long long n8 = n_elem - (n_elem % 8);
    if (n8 > 0) bshuf_transpose_block(in, out, static_cast<size_t>(n8),
                                      static_cast<size_t>(elem_size));
    std::memcpy(out + n8 * elem_size, in + n8 * elem_size,
                static_cast<size_t>((n_elem - n8) * elem_size));
    return 0;
}


// The framed blocks without the header.
long long ffsbench_bshuf_lz4_payload(const uint8_t* src, long long n_elem,
                                 long long elem_size, uint8_t* dst,
                                 long long dst_capacity, long long block_elem) {
    if (block_elem <= 0) return -80;
    const long long block_bytes = block_elem * elem_size;
    uint8_t* scratch = new uint8_t[block_bytes];
    if (block_elem % 8) { delete[] scratch; return -81; }
    const long long n_shuf = n_elem - (n_elem % 8);  // raw tail per upstream
    uint8_t* op = dst;
    long long done = 0;
    while (done < n_shuf) {
        const long long this_elem = (n_shuf - done < block_elem) ? (n_shuf - done) : block_elem;
        const long long this_bytes = this_elem * elem_size;
        ffsbench_bitshuffle_encode(src + done * elem_size, scratch, this_elem, elem_size);
        if (op + 4 - dst > dst_capacity) { delete[] scratch; return -1; }
        long long comp = ffsbench_lz4_compress_block(scratch, this_bytes, op + 4,
                                                dst_capacity - (op - dst) - 4);
        if (comp < 0) { delete[] scratch; return -2; }
        op[0] = static_cast<uint8_t>((comp >> 24) & 0xFF);
        op[1] = static_cast<uint8_t>((comp >> 16) & 0xFF);
        op[2] = static_cast<uint8_t>((comp >> 8) & 0xFF);
        op[3] = static_cast<uint8_t>(comp & 0xFF);
        op += 4 + comp;
        done += this_elem;
    }
    const long long tail_bytes = (n_elem % 8) * elem_size;
    if (tail_bytes) {
        if ((op - dst) + tail_bytes > dst_capacity) { delete[] scratch; return -1; }
        memcpy(op, src + n_shuf * elem_size, static_cast<size_t>(tail_bytes));
        op += tail_bytes;
    }
    delete[] scratch;
    return static_cast<long long>(op - dst);
}
// Header plus payload; returns the bytes written or a negative error.
long long ffsbench_bshuf_lz4_encode(const uint8_t* src, long long n_elem,
                                    long long elem_size, uint8_t* dst,
                                    long long dst_capacity, long long block_elem) {
    if (dst_capacity < 12) return -1;
    const unsigned long long n_bytes = static_cast<unsigned long long>(n_elem * elem_size);
    const unsigned long long b_bytes = static_cast<unsigned long long>(block_elem * elem_size);
    for (int i = 0; i < 8; ++i) dst[i] = static_cast<uint8_t>(n_bytes >> (8 * (7 - i)));
    for (int i = 0; i < 4; ++i) dst[8 + i] = static_cast<uint8_t>(b_bytes >> (8 * (3 - i)));
    const long long n = ffsbench_bshuf_lz4_payload(src, n_elem, elem_size, dst + 12,
                                                   dst_capacity - 12, block_elem);
    return n < 0 ? n : n + 12;
}

}  // extern "C"
