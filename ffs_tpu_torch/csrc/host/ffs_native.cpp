// ffs_native: native decode kernels for the ffs_tpu ingest path.
//
// TPU-native equivalent of the reference's host-side decompression
// (reference: spotfinder/spotfinder.cc:823-855 uses the bitshuffle library's
// bshuf_decompress_lz4; integrator/integrator.cc:907-922 likewise, and CBF
// byte-offset decode lives in spotfinder/cbfread.hpp).  Implemented from the
// published LZ4-block / bitshuffle / CBF format specifications — no vendored
// third-party code.
//
// Exposed as a plain C ABI for ctypes.  All functions return 0 on success,
// negative error codes otherwise.  They hold no global state and are safe to
// call concurrently from multiple threads (the Python side releases the GIL
// through ctypes).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libffs_native.so ffs_native.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// LZ4 block format decoder (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md)
// ---------------------------------------------------------------------------

// Decompress one raw LZ4 block.  Returns bytes written or negative on error.
long long ffs_lz4_decompress_block(const uint8_t* src,
                                   long long src_len,
                                   uint8_t* dst,
                                   long long dst_capacity) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_capacity;

    while (ip < iend) {
        const uint8_t token = *ip++;

        // literals
        size_t lit_len = token >> 4;
        if (lit_len == 15) {
            uint8_t s;
            do {
                if (ip >= iend) return -1;
                s = *ip++;
                lit_len += s;
            } while (s == 255);
        }
        if (ip + lit_len > iend || op + lit_len > oend) return -2;
        std::memcpy(op, ip, lit_len);
        ip += lit_len;
        op += lit_len;

        if (ip >= iend) break;  // last sequence has no match

        // match
        if (ip + 2 > iend) return -3;
        const size_t offset = static_cast<size_t>(ip[0]) | (static_cast<size_t>(ip[1]) << 8);
        ip += 2;
        if (offset == 0 || op - dst < static_cast<ptrdiff_t>(offset)) return -4;

        size_t match_len = token & 0x0F;
        if (match_len == 15) {
            uint8_t s;
            do {
                if (ip >= iend) return -5;
                s = *ip++;
                match_len += s;
            } while (s == 255);
        }
        match_len += 4;
        if (op + match_len > oend) return -6;

        const uint8_t* match = op - offset;
        // overlapping copy must run forward byte-by-byte when offset < len
        if (offset >= match_len) {
            std::memcpy(op, match, match_len);
            op += match_len;
        } else {
            for (size_t i = 0; i < match_len; ++i) *op++ = *match++;
        }
    }
    return static_cast<long long>(op - dst);
}

// Greedy LZ4 block compressor (hash-chain-free; correctness-oriented, used
// for round-trip tests and the SHM writer test fixture).
long long ffs_lz4_compress_block(const uint8_t* src,
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

// ---------------------------------------------------------------------------
// Bitshuffle (https://github.com/kiyo-masui/bitshuffle data layout)
//
// Within a block of n elements (n multiple of 8) of elem_size bytes, the
// shuffled layout stores, for each element-byte j and each bit k (LSB plane
// in row 0), a packed row of n/8 bytes where byte m holds bit k of the j-th
// byte of elements 8m..8m+7 (element 8m+t at bit position t).  Upstream's
// AVX2 kernel writes movemask(MSB) to row 7-kk then shifts left, i.e. row r
// is bit plane r.
// ---------------------------------------------------------------------------

// The untranspose works on 8 x 8 bit matrices: the 8 row bytes at column m
// of one element byte, packed into a 64-bit word with row kk as byte kk,
// hold bit kk of that byte of elements 8m..8m+7 at bit 8 kk + t; transposed
// (bit 8 r + c <-> bit 8 c + r), byte t of the word is the byte of element
// 8m+t.  The SSE2 path (baseline on x86-64) builds 16 such words at a time
// from 16-byte row loads and writes whole 16-byte vectors of 1-, 2- and
// 4-byte elements; the columns past the last run of 16, other element
// sizes and targets without SSE2 take the one-word path.  Both give the
// bytes of the bit-by-bit definition above for every input.
static inline uint64_t bit_transpose8x8(uint64_t x) {
    uint64_t t;
    t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
    x ^= t ^ (t << 7);
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
    x ^= t ^ (t << 14);
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
    x ^= t ^ (t << 28);
    return x;
}

// columns [m_begin, nb) of every element byte, one word at a time
static void untranspose_words(const uint8_t* in, uint8_t* out, size_t n,
                              size_t elem_size, size_t m_begin) {
    const size_t nb = n / 8;
    for (size_t j = 0; j < elem_size; ++j) {
        const uint8_t* rows = in + j * n;
        for (size_t m = m_begin; m < nb; ++m) {
            uint64_t x = 0;
            for (size_t kk = 0; kk < 8; ++kk) {
                x |= static_cast<uint64_t>(rows[kk * nb + m]) << (8 * kk);
            }
            x = bit_transpose8x8(x);
            uint8_t* o = out + 8 * m * elem_size + j;
            for (size_t t = 0; t < 8; ++t) {
                o[t * elem_size] = static_cast<uint8_t>(x >> (8 * t));
            }
        }
    }
}

#if defined(__SSE2__)
static inline __m128i bit_transpose8x8_epi64(__m128i x) {
    const __m128i m7 = _mm_set1_epi64x(0x00AA00AA00AA00AALL);
    const __m128i m14 = _mm_set1_epi64x(0x0000CCCC0000CCCCLL);
    const __m128i m28 = _mm_set1_epi64x(0x00000000F0F0F0F0LL);
    __m128i t = _mm_and_si128(_mm_xor_si128(x, _mm_srli_epi64(x, 7)), m7);
    x = _mm_xor_si128(x, _mm_xor_si128(t, _mm_slli_epi64(t, 7)));
    t = _mm_and_si128(_mm_xor_si128(x, _mm_srli_epi64(x, 14)), m14);
    x = _mm_xor_si128(x, _mm_xor_si128(t, _mm_slli_epi64(t, 14)));
    t = _mm_and_si128(_mm_xor_si128(x, _mm_srli_epi64(x, 28)), m28);
    return _mm_xor_si128(x, _mm_xor_si128(t, _mm_slli_epi64(t, 28)));
}

// The 16 words of columns m..m+15 of the 8 rows at `rows` (row stride nb),
// bit-transposed: v[i] holds the bytes of elements 8(m+2i)..8(m+2i)+15.
static inline void untranspose_run16(const uint8_t* rows, size_t nb, size_t m,
                                     __m128i v[8]) {
    __m128i r[8];
    for (size_t kk = 0; kk < 8; ++kk) {
        r[kk] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(rows + kk * nb + m));
    }
    // byte pairs of rows (0,1), (2,3), (4,5), (6,7): columns 0-7, 8-15
    const __m128i a0 = _mm_unpacklo_epi8(r[0], r[1]), a1 = _mm_unpackhi_epi8(r[0], r[1]);
    const __m128i a2 = _mm_unpacklo_epi8(r[2], r[3]), a3 = _mm_unpackhi_epi8(r[2], r[3]);
    const __m128i a4 = _mm_unpacklo_epi8(r[4], r[5]), a5 = _mm_unpackhi_epi8(r[4], r[5]);
    const __m128i a6 = _mm_unpacklo_epi8(r[6], r[7]), a7 = _mm_unpackhi_epi8(r[6], r[7]);
    // rows 0-3 and 4-7 as 32-bit quads: columns 0-3, 4-7, 8-11, 12-15
    const __m128i b0 = _mm_unpacklo_epi16(a0, a2), b1 = _mm_unpackhi_epi16(a0, a2);
    const __m128i b2 = _mm_unpacklo_epi16(a1, a3), b3 = _mm_unpackhi_epi16(a1, a3);
    const __m128i c0 = _mm_unpacklo_epi16(a4, a6), c1 = _mm_unpackhi_epi16(a4, a6);
    const __m128i c2 = _mm_unpacklo_epi16(a5, a7), c3 = _mm_unpackhi_epi16(a5, a7);
    // one 64-bit word a column, row kk in byte kk
    v[0] = bit_transpose8x8_epi64(_mm_unpacklo_epi32(b0, c0));
    v[1] = bit_transpose8x8_epi64(_mm_unpackhi_epi32(b0, c0));
    v[2] = bit_transpose8x8_epi64(_mm_unpacklo_epi32(b1, c1));
    v[3] = bit_transpose8x8_epi64(_mm_unpackhi_epi32(b1, c1));
    v[4] = bit_transpose8x8_epi64(_mm_unpacklo_epi32(b2, c2));
    v[5] = bit_transpose8x8_epi64(_mm_unpackhi_epi32(b2, c2));
    v[6] = bit_transpose8x8_epi64(_mm_unpacklo_epi32(b3, c3));
    v[7] = bit_transpose8x8_epi64(_mm_unpackhi_epi32(b3, c3));
}

static inline void store16(uint8_t* p, __m128i x) {
    _mm_storeu_si128(reinterpret_cast<__m128i*>(p), x);
}

// columns [0, 16 * (nb / 16)) of 1-, 2- or 4-byte elements; returns the
// first column left to the one-word path
static size_t untranspose_sse2(const uint8_t* in, uint8_t* out, size_t n,
                               size_t elem_size) {
    const size_t nb = n / 8;
    const size_t m_end = nb - nb % 16;
    if (elem_size != 1 && elem_size != 2 && elem_size != 4) return 0;
    for (size_t m = 0; m < m_end; m += 16) {
        __m128i v[4][8];
        for (size_t j = 0; j < elem_size; ++j) untranspose_run16(in + j * n, nb, m, v[j]);
        uint8_t* o = out + 8 * m * elem_size;
        for (size_t i = 0; i < 8; ++i) {
            if (elem_size == 1) {
                store16(o + 16 * i, v[0][i]);
            } else if (elem_size == 2) {
                store16(o + 32 * i, _mm_unpacklo_epi8(v[0][i], v[1][i]));
                store16(o + 32 * i + 16, _mm_unpackhi_epi8(v[0][i], v[1][i]));
            } else {
                const __m128i lo01 = _mm_unpacklo_epi8(v[0][i], v[1][i]);
                const __m128i hi01 = _mm_unpackhi_epi8(v[0][i], v[1][i]);
                const __m128i lo23 = _mm_unpacklo_epi8(v[2][i], v[3][i]);
                const __m128i hi23 = _mm_unpackhi_epi8(v[2][i], v[3][i]);
                store16(o + 64 * i, _mm_unpacklo_epi16(lo01, lo23));
                store16(o + 64 * i + 16, _mm_unpackhi_epi16(lo01, lo23));
                store16(o + 64 * i + 32, _mm_unpacklo_epi16(hi01, hi23));
                store16(o + 64 * i + 48, _mm_unpackhi_epi16(hi01, hi23));
            }
        }
    }
    return m_end;
}
#endif

static void bshuf_untranspose_block(const uint8_t* in,
                                    uint8_t* out,
                                    size_t n,  // elements, multiple of 8
                                    size_t elem_size) {
    size_t m_begin = 0;
#if defined(__SSE2__)
    m_begin = untranspose_sse2(in, out, n, elem_size);
#endif
    untranspose_words(in, out, n, elem_size, m_begin);
}

// Which untranspose the library was built with: 0 the one-word path
// alone, 1 SSE2.
int ffs_untranspose_kind() {
#if defined(__SSE2__)
    return 1;
#else
    return 0;
#endif
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

int ffs_bitshuffle_decode(const uint8_t* in, uint8_t* out, long long n_elem,
                          long long elem_size) {
    const long long n8 = n_elem - (n_elem % 8);
    if (n8 > 0) bshuf_untranspose_block(in, out, static_cast<size_t>(n8),
                                        static_cast<size_t>(elem_size));
    // trailing elements are stored unshuffled
    std::memcpy(out + n8 * elem_size, in + n8 * elem_size,
                static_cast<size_t>((n_elem - n8) * elem_size));
    return 0;
}

int ffs_bitshuffle_encode(const uint8_t* in, uint8_t* out, long long n_elem,
                          long long elem_size) {
    const long long n8 = n_elem - (n_elem % 8);
    if (n8 > 0) bshuf_transpose_block(in, out, static_cast<size_t>(n8),
                                      static_cast<size_t>(elem_size));
    std::memcpy(out + n8 * elem_size, in + n8 * elem_size,
                static_cast<size_t>((n_elem - n8) * elem_size));
    return 0;
}

static uint32_t read_be32(const uint8_t* p) {
    return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16)
           | (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

static long long bshuf_default_block_size(long long elem_size) {
    // bitshuffle's default: target 8192 bytes, multiple of 8 elements
    long long block = 8192 / elem_size;
    block = (block / 8) * 8;
    if (block < 8) block = 8;
    return block;
}

// Decompress a bitshuffle-LZ4 stream (the HDF5 filter-32008 payload *after*
// its 12-byte header): per block, BE u32 compressed length + LZ4 data.
// block_elem <= 0 selects the bitshuffle default block size.
int ffs_bshuf_lz4_decompress(const uint8_t* src, long long src_len,
                             uint8_t* dst, long long n_elem,
                             long long elem_size, long long block_elem) {
    if (block_elem <= 0) block_elem = bshuf_default_block_size(elem_size);
    // scratch for one block
    static thread_local uint8_t* scratch = nullptr;
    static thread_local long long scratch_size = 0;
    const long long block_bytes = block_elem * elem_size;
    if (scratch_size < block_bytes) {
        delete[] scratch;
        scratch = new uint8_t[block_bytes];
        scratch_size = block_bytes;
    }

    if (block_elem % 8) return -81;  // upstream bitshuffle's block rule

    // Upstream framing (bitshuffle bshuf_blocked_wrap_fun): only the first
    // n_elem - n_elem % 8 elements are bitshuffled into length-prefixed LZ4
    // blocks; the final n_elem % 8 elements are appended RAW after all
    // blocks (not folded into the last block).
    const long long n_shuf = n_elem - (n_elem % 8);
    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    long long done = 0;
    while (done < n_shuf) {
        const long long this_elem = (n_shuf - done < block_elem) ? (n_shuf - done) : block_elem;
        const long long this_bytes = this_elem * elem_size;
        if (ip + 4 > iend) return -10;
        const uint32_t comp_len = read_be32(ip);
        ip += 4;
        if (ip + comp_len > iend) return -11;
        const long long written =
            ffs_lz4_decompress_block(ip, comp_len, scratch, this_bytes);
        if (written != this_bytes) return -12;
        ip += comp_len;
        ffs_bitshuffle_decode(scratch, dst + done * elem_size, this_elem, elem_size);
        done += this_elem;
    }
    const long long tail_bytes = (n_elem % 8) * elem_size;
    if (tail_bytes) {
        if (ip + tail_bytes > iend) return -13;
        memcpy(dst + n_shuf * elem_size, ip, static_cast<size_t>(tail_bytes));
    }
    return 0;
}

// LZ4-only half of the chunk decode: per-block LZ4 into a stacked plane
// matrix of (n_blocks, block_elem * elem_size) rows, leaving the bit
// untranspose to the caller (the TPU — ops/bitshuffle_device.py; the
// decompression-offload split the reference flags as a TODO,
// spotfinder.cc:823-842).  A partial final block is bit-transposed at its
// own extent, so its (S, 8, this_elem/8) rows are re-spread to the
// full-block (S, 8, block_elem/8) row offsets; the padding decodes to
// zero elements the caller slices off.  `planes` must hold
// ceil(n_shuf/block_elem) * block_elem * elem_size zero-initialised
// bytes.  Returns 0 on success.
int ffs_bshuf_lz4_planes(const uint8_t* src, long long src_len,
                         uint8_t* planes, long long n_elem,
                         long long elem_size, long long block_elem) {
    if (block_elem <= 0) block_elem = bshuf_default_block_size(elem_size);
    if (block_elem % 8) return -81;
    const long long block_bytes = block_elem * elem_size;
    const long long n_shuf = n_elem - (n_elem % 8);
    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    long long done = 0;
    uint8_t* row = planes;
    while (done < n_shuf) {
        const long long this_elem = (n_shuf - done < block_elem) ? (n_shuf - done) : block_elem;
        const long long this_bytes = this_elem * elem_size;
        if (ip + 4 > iend) return -10;
        const uint32_t comp_len = read_be32(ip);
        ip += 4;
        if (ip + comp_len > iend) return -11;
        const long long written =
            ffs_lz4_decompress_block(ip, comp_len, row, this_bytes);
        if (written != this_bytes) return -12;
        ip += comp_len;
        if (this_elem < block_elem) {
            // re-spread the partial block's rows (back to front so the
            // in-place moves never overlap a not-yet-moved source row)
            const long long src_m = this_elem / 8;
            const long long dst_m = block_elem / 8;
            for (long long r = 8 * elem_size - 1; r > 0; --r) {
                memmove(row + r * dst_m, row + r * src_m,
                        static_cast<size_t>(src_m));
            }
            for (long long r = 0; r < 8 * elem_size; ++r) {
                memset(row + r * dst_m + src_m, 0,
                       static_cast<size_t>(dst_m - src_m));
            }
        }
        done += this_elem;
        row += block_bytes;
    }
    return 0;
}

// Compress with the same framing (testing fixture / SHM writer).
long long ffs_bshuf_lz4_compress(const uint8_t* src, long long n_elem,
                                 long long elem_size, uint8_t* dst,
                                 long long dst_capacity, long long block_elem) {
    if (block_elem <= 0) block_elem = bshuf_default_block_size(elem_size);
    const long long block_bytes = block_elem * elem_size;
    uint8_t* scratch = new uint8_t[block_bytes];
    if (block_elem % 8) { delete[] scratch; return -81; }
    const long long n_shuf = n_elem - (n_elem % 8);  // raw tail per upstream
    uint8_t* op = dst;
    long long done = 0;
    while (done < n_shuf) {
        const long long this_elem = (n_shuf - done < block_elem) ? (n_shuf - done) : block_elem;
        const long long this_bytes = this_elem * elem_size;
        ffs_bitshuffle_encode(src + done * elem_size, scratch, this_elem, elem_size);
        if (op + 4 - dst > dst_capacity) { delete[] scratch; return -1; }
        long long comp = ffs_lz4_compress_block(scratch, this_bytes, op + 4,
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

// ---------------------------------------------------------------------------
// 2D connected components over compact strong pixels.
//
// The device computes the dispersion threshold and stream-compaction; the
// host labels the resulting few-thousand-pixel list — the same split as the
// reference, whose CUDA kernels threshold on the GPU and whose
// boost::graph connected components run on the CPU (reference:
// spotfinder/connected_components/connected_components.cc:17-139).
// Union-find with path compression over the raster-sorted linear indices:
// left neighbours are adjacent entries, up neighbours located by binary
// search.  Per-spot statistics and ordering (ascending root linear index)
// match ops/connected_components.py::spot_table_from_pixels.
// ---------------------------------------------------------------------------

static int32_t cc2d_find(int32_t* parent, int32_t i) {
    int32_t root = i;
    while (parent[root] != root) root = parent[root];
    while (parent[i] != root) {
        int32_t next = parent[i];
        parent[i] = root;
        i = next;
    }
    return root;
}

// Labels + per-spot statistics.  lin must be sorted ascending (raster
// order).  Outputs sized n (spot arrays use the first *n_spots entries).
// Returns 0 on success.
int ffs_cc2d(const int32_t* lin, const int32_t* inten, int32_t n,
             int32_t width,
             int32_t* root_lin,   // (n) per-pixel root linear index
             int32_t* spot_id,    // (n) per-pixel dense spot id
             int32_t* n_spots_out,
             int32_t* n_px,       // per-spot pixel count
             long long* sum_i,    // per-spot intensity sum
             long long* sum_ix,   // per-spot sum I*x
             long long* sum_iy,   // per-spot sum I*y
             int32_t* bbox,       // per-spot x_min, x_max, y_min, y_max
             int32_t* peak_i,     // per-spot peak intensity
             int32_t* peak_lin) { // per-spot peak linear index
    if (n < 0) return -1;
    if (n == 0) {
        *n_spots_out = 0;
        return 0;
    }
    std::vector<int32_t> parent(n);
    for (int32_t i = 0; i < n; ++i) parent[i] = i;

    for (int32_t i = 0; i < n; ++i) {
        const int32_t l = lin[i];
        const int32_t x = l % width;
        // left neighbour: previous entry (raster-sorted), same row
        if (i > 0 && x > 0 && lin[i - 1] == l - 1) {
            int32_t a = cc2d_find(parent.data(), i);
            int32_t b = cc2d_find(parent.data(), i - 1);
            if (a != b) parent[a > b ? a : b] = a > b ? b : a;
        }
        // up neighbour: binary search for l - width
        if (l >= width) {
            const int32_t target = l - width;
            const int32_t* lo =
                std::lower_bound(lin, lin + i, target);
            if (lo != lin + i && *lo == target) {
                int32_t j = static_cast<int32_t>(lo - lin);
                int32_t a = cc2d_find(parent.data(), i);
                int32_t b = cc2d_find(parent.data(), j);
                if (a != b) parent[a > b ? a : b] = a > b ? b : a;
            }
        }
    }

    // dense ids in raster order of roots: pixels ascend in lin, so the
    // first pixel of each component IS its root (minimum linear index)
    int32_t n_spots = 0;
    for (int32_t i = 0; i < n; ++i) {
        int32_t r = cc2d_find(parent.data(), i);
        root_lin[i] = lin[r];
        int32_t id;
        if (r == i) {
            id = n_spots++;
            spot_id[i] = id;
            n_px[id] = 0;
            sum_i[id] = sum_ix[id] = sum_iy[id] = 0;
            bbox[4 * id + 0] = INT32_MAX;
            bbox[4 * id + 1] = -1;
            bbox[4 * id + 2] = INT32_MAX;
            bbox[4 * id + 3] = -1;
            peak_i[id] = -1;
            peak_lin[id] = INT32_MAX;
        } else {
            id = spot_id[r];
            spot_id[i] = id;
        }
        const int32_t x = lin[i] % width;
        const int32_t y = lin[i] / width;
        const long long v = inten[i];
        n_px[id] += 1;
        sum_i[id] += v;
        sum_ix[id] += v * x;
        sum_iy[id] += v * y;
        if (x < bbox[4 * id + 0]) bbox[4 * id + 0] = x;
        if (x > bbox[4 * id + 1]) bbox[4 * id + 1] = x;
        if (y < bbox[4 * id + 2]) bbox[4 * id + 2] = y;
        if (y > bbox[4 * id + 3]) bbox[4 * id + 3] = y;
        // peak: max intensity, ties -> smallest linear index (ascending
        // iteration keeps the first maximum)
        if (inten[i] > peak_i[id]) {
            peak_i[id] = inten[i];
            peak_lin[id] = lin[i];
        }
    }
    *n_spots_out = n_spots;
    return 0;
}

// ---------------------------------------------------------------------------
// CBF byte-offset decompression (reference behaviour: spotfinder/cbfread.hpp)
// ---------------------------------------------------------------------------

// Decode CBF byte-offset into int32.  Returns elements written or negative.
long long ffs_byte_offset_decompress(const uint8_t* src, long long src_len,
                                     int32_t* dst, long long n_out) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    int64_t value = 0;
    long long n = 0;
    while (ip < iend && n < n_out) {
        int8_t d8 = static_cast<int8_t>(*ip++);
        if (d8 != -128) {
            value += d8;
        } else {
            if (ip + 2 > iend) return -1;
            int16_t d16;
            std::memcpy(&d16, ip, 2);
            ip += 2;
            if (d16 != -32768) {
                value += d16;
            } else {
                if (ip + 4 > iend) return -2;
                int32_t d32;
                std::memcpy(&d32, ip, 4);
                ip += 4;
                value += d32;
            }
        }
        dst[n++] = static_cast<int32_t>(value);
    }
    return n;
}

// ---------------------------------------------------------------------------
// Host stream compaction from packed strong words.
//
// The fused dispersion kernel emits combined [pc | w32] rows (see
// ops/dispersion_pallas._pack_pcw: bit t of word j = image column j*32+t,
// pc lanes are the within-row inclusive word popcount prefix).  With
// locally-attached hardware the cheapest production split ends the
// device's job at those packed words: the host expands set bits to
// (linear index, intensity) against its own decoded frame copy, then the
// existing host union-find labels them (the reference's GPU-threshold /
// CPU-connected-components split taken one stage earlier;
// spotfinder/connected_components/connected_components.cc:24-31 is the
// equivalent host pixel scan).
// ---------------------------------------------------------------------------

// Scan the word half of pcw ((rows, 2*nwl) i32, row-major) emitting
// raster-ordered linear indices and intensities read from image
// (row stride img_w elements of elem_size = 1/2/4 bytes, zero-extended).
// Writes at most cap entries but ALWAYS returns the true total count;
// callers detect overflow by total > cap.  Bits at columns >= width never
// occur (the kernel's zero-padded mask forces the predicate false there).
long long ffs_compact_pcw(const int32_t* pcw, long long rows, long long nwl,
                          const void* image, long long img_w,
                          int32_t elem_size, long long width,
                          int32_t* out_lin, int32_t* out_val,
                          long long cap) {
    const uint8_t* img8 = static_cast<const uint8_t*>(image);
    long long n = 0;
    for (long long r = 0; r < rows; ++r) {
        const int32_t* row = pcw + r * 2 * nwl;
        if (row[nwl - 1] == 0) continue;  // row-total prefix: skip empty rows
        const uint8_t* irow = img8 + r * img_w * elem_size;
        for (long long j = 0; j < nwl; ++j) {
            uint32_t w = static_cast<uint32_t>(row[nwl + j]);
            while (w) {
                const int32_t x =
                    static_cast<int32_t>(j * 32) + __builtin_ctz(w);
                w &= w - 1;
                if (n < cap) {
                    out_lin[n] = static_cast<int32_t>(r * width) + x;
                    uint32_t v;
                    switch (elem_size) {
                        case 1:
                            v = irow[x];
                            break;
                        case 2: {
                            uint16_t t;
                            std::memcpy(&t, irow + 2ll * x, 2);
                            v = t;
                            break;
                        }
                        default: {
                            std::memcpy(&v, irow + 4ll * x, 4);
                            break;
                        }
                    }
                    out_val[n] = static_cast<int32_t>(v);
                }
                ++n;
            }
        }
    }
    return n;
}

}  // extern "C"
