/* A zstd decoder written from RFC 8878, for the port's reader of Orbax
 * checkpoints (compat/zstd.py): tensorstore compresses every OCDBT node and
 * every zarr chunk of a JAX checkpoint with zstd, and the machine that
 * restores it has no zstd library to call.
 *
 * Covered: zstd frames with or without a content size and a checksum
 * (XXH64, verified), skippable frames, concatenated frames; raw, RLE and
 * compressed blocks; raw, RLE, Huffman (one and four streams) and treeless
 * literals, Huffman weights given directly or by FSE; predefined, RLE, FSE
 * and repeat modes of the three sequence codes, and the repeat offsets.
 * Treeless literals and repeat modes reuse the tables of earlier blocks of
 * the same frame.  Not covered: dictionaries (a frame with a dictionary ID
 * is an error).  There is no encoder.
 *
 * A frame is decoded whole into the caller's buffer, so the window is that
 * buffer: a match may reach back to the start of its frame, never further.
 * Every read is checked against the input's end and every write against
 * the output's capacity; malformed input returns a negative code
 * (zstd_error_string names it) and never touches memory outside the two
 * buffers.  No global state: calls may run in parallel threads.
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
    ZSTD_OK = 0,
    ZSTD_E_TRUNCATED = -1,
    ZSTD_E_MAGIC = -2,
    ZSTD_E_RESERVED = -3,
    ZSTD_E_DICTIONARY = -4,
    ZSTD_E_BLOCK_TYPE = -5,
    ZSTD_E_CORRUPT = -6,
    ZSTD_E_DST_TOO_SMALL = -7,
    ZSTD_E_CHECKSUM = -8,
    ZSTD_E_SIZE_MISMATCH = -9,
    ZSTD_E_NO_MEMORY = -10,
    ZSTD_E_NO_TABLE = -11,
};

const char *zstd_error_string(int code) {
    switch (code) {
    case ZSTD_OK: return "ok";
    case ZSTD_E_TRUNCATED: return "input ends inside a frame";
    case ZSTD_E_MAGIC: return "not a zstd frame (bad magic number)";
    case ZSTD_E_RESERVED: return "a reserved bit or value is set";
    case ZSTD_E_DICTIONARY: return "frame needs a dictionary (not supported)";
    case ZSTD_E_BLOCK_TYPE: return "reserved block type";
    case ZSTD_E_CORRUPT: return "corrupt compressed data";
    case ZSTD_E_DST_TOO_SMALL: return "output buffer too small";
    case ZSTD_E_CHECKSUM: return "content checksum mismatch";
    case ZSTD_E_SIZE_MISMATCH: return "decoded size differs from the frame's content size";
    case ZSTD_E_NO_MEMORY: return "out of memory";
    case ZSTD_E_NO_TABLE: return "treeless literals or repeat mode with no earlier table in the frame";
    default: return "unknown error";
    }
}

#define ZSTD_MAGIC 0xFD2FB528u
#define SKIPPABLE_MASK 0xFFFFFFF0u
#define SKIPPABLE_MAGIC 0x184D2A50u
#define BLOCK_MAX (128 * 1024)
#define HUF_MAX_BITS 11
#define LL_MAX_SYM 35
#define ML_MAX_SYM 52
#define OF_MAX_SYM 31
#define LL_MAX_LOG 9
#define ML_MAX_LOG 9
#define OF_MAX_LOG 8
#define HUF_WEIGHT_MAX_LOG 6

#define CHECK(expr) do { int rc_ = (expr); if (rc_) return rc_; } while (0)

/* ------------------------------------------------------------------ */
/* Little-endian loads                                                 */
/* ------------------------------------------------------------------ */

static inline uint64_t le64(const uint8_t *p) {
    uint64_t v;
    memcpy(&v, p, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
    v = __builtin_bswap64(v);
#endif
    return v;
}

static inline uint32_t le32(const uint8_t *p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
           (uint32_t)p[3] << 24;
}

static inline uint32_t le24(const uint8_t *p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16;
}

static inline uint32_t le16(const uint8_t *p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8;
}

static inline int highbit32(uint32_t v) { /* v > 0 */
    return 31 - __builtin_clz(v);
}

/* ------------------------------------------------------------------ */
/* XXH64, for the frame checksum (its low 32 bits)                     */
/* ------------------------------------------------------------------ */

#define XP1 11400714785074694791ULL
#define XP2 14029467366897019727ULL
#define XP3 1609587929392839161ULL
#define XP4 9650029242287828579ULL
#define XP5 2870177450012600261ULL

static inline uint64_t rotl64(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

static inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
    acc += in * XP2;
    acc = rotl64(acc, 31);
    return acc * XP1;
}

static inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
    acc ^= xxh_round(0, v);
    return acc * XP1 + XP4;
}

static uint64_t xxh64(const uint8_t *p, size_t len) {
    const uint8_t *end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = XP1 + XP2, v2 = XP2, v3 = 0, v4 = (uint64_t)0 - XP1;
        const uint8_t *limit = end - 32;
        do {
            v1 = xxh_round(v1, le64(p));
            v2 = xxh_round(v2, le64(p + 8));
            v3 = xxh_round(v3, le64(p + 16));
            v4 = xxh_round(v4, le64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = XP5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= xxh_round(0, le64(p));
        h = rotl64(h, 27) * XP1 + XP4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)le32(p) * XP1;
        h = rotl64(h, 23) * XP2 + XP3;
        p += 4;
    }
    while (p < end) {
        h ^= (uint64_t)(*p) * XP5;
        h = rotl64(h, 11) * XP1;
        p++;
    }
    h ^= h >> 33;
    h *= XP2;
    h ^= h >> 29;
    h *= XP3;
    h ^= h >> 32;
    return h;
}

/* ------------------------------------------------------------------ */
/* Bit readers                                                         */
/* ------------------------------------------------------------------ */

/* Forward, least significant bit first (FSE table descriptions).  Bits
 * past the end read as zero; the caller checks what it consumed. */
static uint32_t fwd_peek(const uint8_t *s, size_t len, size_t bitpos, int n) {
    size_t byte = bitpos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 8 && byte + (size_t)i < len; i++)
        v |= (uint64_t)s[byte + i] << (8 * i);
    return (uint32_t)((v >> (bitpos & 7)) & ((1ull << n) - 1));
}

/* Backward (Huffman and FSE streams): the stream is read from its last
 * byte towards its first; the highest set bit of the last byte marks the
 * start.  pos counts the bits not yet read; a read takes the n bits below
 * pos, the first-read bit most significant.  Bits below 0 read as zero and
 * drive pos negative, which the callers check. */
typedef struct {
    const uint8_t *s;
    size_t len;
    int64_t pos;
} bwd_t;

static int bwd_init(bwd_t *b, const uint8_t *s, size_t len) {
    if (len == 0 || s[len - 1] == 0) return ZSTD_E_CORRUPT;
    b->s = s;
    b->len = len;
    b->pos = (int64_t)(len - 1) * 8 + highbit32(s[len - 1]);
    return ZSTD_OK;
}

static uint64_t bwd_peek_slow(const bwd_t *b, int64_t lo, int n) {
    uint64_t v = 0;
    for (int i = n - 1; i >= 0; i--) {
        int64_t p = lo + i;
        uint64_t bit = 0;
        if (p >= 0 && (size_t)(p >> 3) < b->len)
            bit = (b->s[p >> 3] >> (p & 7)) & 1;
        v = (v << 1) | bit;
    }
    return v;
}

static inline uint64_t bwd_peek(const bwd_t *b, int n) { /* 0 <= n <= 56 */
    int64_t lo = b->pos - n;
    if (lo >= 0 && (size_t)(lo >> 3) + 8 <= b->len)
        return (le64(b->s + (lo >> 3)) >> (lo & 7)) & ((1ull << n) - 1);
    return bwd_peek_slow(b, lo, n);
}

static inline uint64_t bwd_read(bwd_t *b, int n) {
    uint64_t v = bwd_peek(b, n);
    b->pos -= n;
    return v;
}

/* ------------------------------------------------------------------ */
/* FSE tables                                                          */
/* ------------------------------------------------------------------ */

typedef struct {
    uint16_t next; /* baseline of the next state */
    uint8_t sym;
    uint8_t nbits;
} fse_entry;

/* Reads an FSE table description (RFC 8878 4.1.1): the accuracy log and
 * the normalized counts of symbols 0..*nsym-1 (-1 = "less than 1"). */
static int fse_read_counts(const uint8_t *s, size_t len, int max_sym,
                           int max_log, int16_t *norm, int *nsym, int *log,
                           size_t *used) {
    size_t bp = 0;
    int acc = (int)fwd_peek(s, len, bp, 4) + 5;
    bp += 4;
    if (acc > max_log) return ZSTD_E_CORRUPT;
    int remaining = (1 << acc) + 1;
    int threshold = 1 << acc;
    int nbits = acc + 1;
    int sym = 0;
    int prev0 = 0;
    while (remaining > 1) {
        if (prev0) {
            int n0 = sym;
            for (;;) {
                uint32_t r = fwd_peek(s, len, bp, 2);
                bp += 2;
                n0 += (int)r;
                if (r != 3) break;
                if (n0 > max_sym + 1 || (bp >> 3) > len) return ZSTD_E_CORRUPT;
            }
            if (n0 > max_sym + 1) return ZSTD_E_CORRUPT;
            while (sym < n0) norm[sym++] = 0;
        }
        if (sym > max_sym) return ZSTD_E_CORRUPT;
        int max = (2 * threshold - 1) - remaining;
        uint32_t v = fwd_peek(s, len, bp, nbits);
        int count;
        if ((int)(v & (uint32_t)(threshold - 1)) < max) {
            count = (int)(v & (uint32_t)(threshold - 1));
            bp += (size_t)(nbits - 1);
        } else {
            count = (int)(v & (uint32_t)(2 * threshold - 1));
            if (count >= threshold) count -= max;
            bp += (size_t)nbits;
        }
        count--;
        remaining -= count < 0 ? -count : count;
        norm[sym++] = (int16_t)count;
        prev0 = count == 0;
        if (remaining < threshold) {
            if (remaining <= 1) break;
            nbits = highbit32((uint32_t)remaining) + 1;
            threshold = 1 << (nbits - 1);
        }
    }
    if (remaining != 1 || (bp + 7) / 8 > len) return ZSTD_E_CORRUPT;
    *nsym = sym;
    *log = acc;
    *used = (bp + 7) / 8;
    return ZSTD_OK;
}

static int fse_build(fse_entry *t, const int16_t *norm, int nsym, int log) {
    const int size = 1 << log;
    int high = size - 1;
    uint16_t next[256];
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1) {
            t[high--].sym = (uint8_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint16_t)norm[s];
        }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            t[pos].sym = (uint8_t)s;
            do pos = (pos + step) & mask; while (pos > high);
        }
    }
    if (pos != 0) return ZSTD_E_CORRUPT;
    for (int u = 0; u < size; u++) {
        uint32_t x = next[t[u].sym]++;
        int nb = log - highbit32(x);
        t[u].nbits = (uint8_t)nb;
        t[u].next = (uint16_t)((x << nb) - (uint32_t)size);
    }
    return ZSTD_OK;
}

/* ------------------------------------------------------------------ */
/* Decoder state kept across the blocks of one frame                   */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t sym;
    uint8_t nbits;
} huf_entry;

typedef struct {
    huf_entry huf[1 << HUF_MAX_BITS];
    int huf_log, huf_ok;
    fse_entry ll[1 << LL_MAX_LOG], of[1 << OF_MAX_LOG], ml[1 << ML_MAX_LOG];
    int ll_log, of_log, ml_log;
    int ll_ok, of_ok, ml_ok;
    size_t rep[3];
    uint8_t lit[BLOCK_MAX];
} dctx;

static const int16_t LL_DEFAULT[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

static const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
    1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
    1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

/* ------------------------------------------------------------------ */
/* Literals                                                            */
/* ------------------------------------------------------------------ */

/* Huffman weights compressed with FSE (RFC 8878 4.2.1.2): two states
 * interleaved over one backward stream, until a state update runs past
 * the stream's start; then the other state gives the last weight. */
static int huf_fse_weights(const uint8_t *s, size_t len, uint8_t *w,
                           size_t *nw) {
    int16_t norm[256];
    int nsym, log;
    size_t used;
    fse_entry t[1 << HUF_WEIGHT_MAX_LOG];
    CHECK(fse_read_counts(s, len, 255, HUF_WEIGHT_MAX_LOG, norm, &nsym,
                          &log, &used));
    CHECK(fse_build(t, norm, nsym, log));
    bwd_t b;
    CHECK(bwd_init(&b, s + used, len - used));
    uint32_t s1 = (uint32_t)bwd_read(&b, log);
    uint32_t s2 = (uint32_t)bwd_read(&b, log);
    if (b.pos < 0) return ZSTD_E_CORRUPT;
    size_t n = 0;
    for (;;) {
        if (n + 2 > 255) return ZSTD_E_CORRUPT;
        w[n++] = t[s1].sym;
        s1 = t[s1].next + (uint32_t)bwd_read(&b, t[s1].nbits);
        if (b.pos < 0) {
            w[n++] = t[s2].sym;
            break;
        }
        w[n++] = t[s2].sym;
        s2 = t[s2].next + (uint32_t)bwd_read(&b, t[s2].nbits);
        if (b.pos < 0) {
            if (n + 1 > 255) return ZSTD_E_CORRUPT;
            w[n++] = t[s1].sym;
            break;
        }
    }
    *nw = n;
    return ZSTD_OK;
}

/* Huffman tree description (RFC 8878 4.2.1): the weights, the implied
 * last weight, and the decoding table indexed by the next max_bits bits. */
static int huf_read_table(dctx *c, const uint8_t *s, size_t len,
                          size_t *used) {
    uint8_t w[256];
    size_t nw;
    if (len < 1) return ZSTD_E_CORRUPT;
    unsigned hb = s[0];
    if (hb >= 128) {
        nw = hb - 127;
        size_t bytes = (nw + 1) / 2;
        if (1 + bytes > len) return ZSTD_E_CORRUPT;
        for (size_t i = 0; i < nw; i++) {
            uint8_t byte = s[1 + i / 2];
            w[i] = (i & 1) ? (byte & 15) : (byte >> 4);
        }
        *used = 1 + bytes;
    } else {
        if (hb == 0 || 1 + (size_t)hb > len) return ZSTD_E_CORRUPT;
        CHECK(huf_fse_weights(s + 1, hb, w, &nw));
        *used = 1 + (size_t)hb;
    }
    uint32_t total = 0;
    for (size_t i = 0; i < nw; i++) {
        if (w[i] > HUF_MAX_BITS) return ZSTD_E_CORRUPT;
        if (w[i]) total += 1u << (w[i] - 1);
    }
    if (total == 0) return ZSTD_E_CORRUPT;
    int max_bits = highbit32(total) + 1;
    if (max_bits > HUF_MAX_BITS) return ZSTD_E_CORRUPT;
    uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1)) return ZSTD_E_CORRUPT;
    w[nw++] = (uint8_t)(highbit32(rest) + 1);
    size_t rank1 = 0;
    for (size_t i = 0; i < nw; i++) rank1 += w[i] == 1;
    if (rank1 < 2 || (rank1 & 1)) return ZSTD_E_CORRUPT;
    /* Codes go to the lowest weights first, symbols in order within a
     * weight: a symbol of weight wt takes 2^(wt-1) consecutive entries. */
    size_t pos = 0;
    for (int wt = 1; wt <= max_bits; wt++) {
        for (size_t sym = 0; sym < nw; sym++) {
            if (w[sym] != wt) continue;
            size_t n = (size_t)1 << (wt - 1);
            huf_entry e = {(uint8_t)sym, (uint8_t)(max_bits + 1 - wt)};
            for (size_t k = 0; k < n; k++) c->huf[pos + k] = e;
            pos += n;
        }
    }
    if (pos != ((size_t)1 << max_bits)) return ZSTD_E_CORRUPT;
    c->huf_log = max_bits;
    c->huf_ok = 1;
    return ZSTD_OK;
}

static int huf_stream(const dctx *c, const uint8_t *s, size_t len,
                      uint8_t *out, size_t n) {
    bwd_t b;
    CHECK(bwd_init(&b, s, len));
    const int bits = c->huf_log;
    const huf_entry *table = c->huf;
    for (size_t i = 0; i < n; i++) {
        huf_entry e = table[bwd_peek(&b, bits)];
        out[i] = e.sym;
        b.pos -= e.nbits;
    }
    return b.pos == 0 ? ZSTD_OK : ZSTD_E_CORRUPT;
}

/* Four streams (RFC 8878 3.1.1.3.1.6): the first three decode seg
 * symbols each, the last the rest.  They are decoded in lockstep, four
 * independent chains of lookups, which hides each lookup's latency. */
static int huf_4streams(const dctx *c, const uint8_t *s, const size_t *len,
                        uint8_t *out, size_t seg, size_t regen) {
    bwd_t b[4];
    uint8_t *o[4];
    size_t n[4];
    for (int k = 0; k < 4; k++) {
        CHECK(bwd_init(&b[k], s, len[k]));
        s += len[k];
        o[k] = out + (size_t)k * seg;
        n[k] = k < 3 ? seg : regen - 3 * seg;
    }
    const int bits = c->huf_log;
    const huf_entry *table = c->huf;
    for (size_t i = 0; i < n[3]; i++) { /* n[3] <= seg */
        const huf_entry e0 = table[bwd_peek(&b[0], bits)];
        const huf_entry e1 = table[bwd_peek(&b[1], bits)];
        const huf_entry e2 = table[bwd_peek(&b[2], bits)];
        const huf_entry e3 = table[bwd_peek(&b[3], bits)];
        o[0][i] = e0.sym;
        o[1][i] = e1.sym;
        o[2][i] = e2.sym;
        o[3][i] = e3.sym;
        b[0].pos -= e0.nbits;
        b[1].pos -= e1.nbits;
        b[2].pos -= e2.nbits;
        b[3].pos -= e3.nbits;
    }
    for (int k = 0; k < 3; k++) {
        for (size_t i = n[3]; i < n[k]; i++) {
            const huf_entry e = table[bwd_peek(&b[k], bits)];
            o[k][i] = e.sym;
            b[k].pos -= e.nbits;
        }
    }
    for (int k = 0; k < 4; k++)
        if (b[k].pos != 0) return ZSTD_E_CORRUPT;
    return ZSTD_OK;
}

/* The literals section (RFC 8878 3.1.1.3.1): *lit points at the block's
 * literals (in the input for raw ones, in c->lit otherwise). */
static int read_literals(dctx *c, const uint8_t *ip, size_t len,
                         const uint8_t **lit, size_t *nlit, size_t *used) {
    if (len < 1) return ZSTD_E_CORRUPT;
    const int type = ip[0] & 3, sf = (ip[0] >> 2) & 3;
    size_t regen, hs;
    if (type == 0 || type == 1) { /* raw, RLE */
        if (sf == 0 || sf == 2) {
            regen = ip[0] >> 3;
            hs = 1;
        } else if (sf == 1) {
            if (len < 2) return ZSTD_E_CORRUPT;
            regen = (ip[0] >> 4) + ((size_t)ip[1] << 4);
            hs = 2;
        } else {
            if (len < 3) return ZSTD_E_CORRUPT;
            regen = (ip[0] >> 4) + ((size_t)ip[1] << 4) + ((size_t)ip[2] << 12);
            hs = 3;
        }
        if (regen > BLOCK_MAX) return ZSTD_E_CORRUPT;
        if (type == 0) {
            if (hs + regen > len) return ZSTD_E_CORRUPT;
            *lit = ip + hs;
            *used = hs + regen;
        } else {
            if (hs + 1 > len) return ZSTD_E_CORRUPT;
            memset(c->lit, ip[hs], regen);
            *lit = c->lit;
            *used = hs + 1;
        }
        *nlit = regen;
        return ZSTD_OK;
    }
    /* compressed (2) or treeless (3) */
    size_t csize;
    int four;
    if (sf <= 1) {
        if (len < 3) return ZSTD_E_CORRUPT;
        uint32_t h = le24(ip);
        regen = (h >> 4) & 0x3FF;
        csize = (h >> 14) & 0x3FF;
        hs = 3;
        four = sf == 1;
    } else if (sf == 2) {
        if (len < 4) return ZSTD_E_CORRUPT;
        uint32_t h = le32(ip);
        regen = (h >> 4) & 0x3FFF;
        csize = (h >> 18) & 0x3FFF;
        hs = 4;
        four = 1;
    } else {
        if (len < 5) return ZSTD_E_CORRUPT;
        uint64_t h = (uint64_t)le32(ip) | (uint64_t)ip[4] << 32;
        regen = (size_t)((h >> 4) & 0x3FFFF);
        csize = (size_t)((h >> 22) & 0x3FFFF);
        hs = 5;
        four = 1;
    }
    if (regen > BLOCK_MAX || hs + csize > len) return ZSTD_E_CORRUPT;
    const uint8_t *p = ip + hs;
    size_t n = csize;
    if (type == 2) {
        size_t tu;
        CHECK(huf_read_table(c, p, n, &tu));
        p += tu;
        n -= tu;
    } else if (!c->huf_ok) {
        return ZSTD_E_NO_TABLE;
    }
    if (!four) {
        CHECK(huf_stream(c, p, n, c->lit, regen));
    } else {
        if (n < 6) return ZSTD_E_CORRUPT;
        size_t s1 = le16(p), s2 = le16(p + 2), s3 = le16(p + 4);
        if (6 + s1 + s2 + s3 > n) return ZSTD_E_CORRUPT;
        const size_t sizes[4] = {s1, s2, s3, n - 6 - s1 - s2 - s3};
        size_t seg = (regen + 3) / 4;
        if (3 * seg > regen) return ZSTD_E_CORRUPT;
        CHECK(huf_4streams(c, p + 6, sizes, c->lit, seg, regen));
    }
    *lit = c->lit;
    *nlit = regen;
    *used = hs + csize;
    return ZSTD_OK;
}

/* ------------------------------------------------------------------ */
/* Sequences                                                           */
/* ------------------------------------------------------------------ */

static int seq_table(const uint8_t **ip, const uint8_t *end, int mode,
                     fse_entry *t, int *log, int *ok, const int16_t *def,
                     int def_nsym, int def_log, int max_sym, int max_log) {
    if (mode == 0) {
        CHECK(fse_build(t, def, def_nsym, def_log));
        *log = def_log;
    } else if (mode == 1) {
        if (*ip >= end) return ZSTD_E_CORRUPT;
        uint8_t sym = *(*ip)++;
        if (sym > max_sym) return ZSTD_E_CORRUPT;
        t[0].sym = sym;
        t[0].nbits = 0;
        t[0].next = 0;
        *log = 0;
    } else if (mode == 2) {
        int16_t norm[256];
        int nsym, acc;
        size_t used;
        CHECK(fse_read_counts(*ip, (size_t)(end - *ip), max_sym, max_log,
                              norm, &nsym, &acc, &used));
        CHECK(fse_build(t, norm, nsym, acc));
        *ip += used;
        *log = acc;
    } else if (!*ok) {
        return ZSTD_E_NO_TABLE;
    }
    *ok = 1;
    return ZSTD_OK;
}

static inline void copy_match(uint8_t *op, size_t off, size_t n) {
    const uint8_t *m = op - off;
    if (off >= n) {
        memcpy(op, m, n);
        return;
    }
    if (off >= 8) { /* each 8-byte piece reads bytes already written */
        while (n >= 8) {
            memcpy(op, m, 8);
            op += 8;
            m += 8;
            n -= 8;
        }
    }
    while (n--) *op++ = *m++;
}

static int decode_block(dctx *c, const uint8_t *ip, size_t bsize,
                        uint8_t *frame_start, uint8_t **opp, uint8_t *oend) {
    const uint8_t *end = ip + bsize;
    uint8_t *op = *opp;
    uint8_t *const block_start = op;
    const uint8_t *lit;
    size_t nlit, used;
    CHECK(read_literals(c, ip, bsize, &lit, &nlit, &used));
    ip += used;
    const uint8_t *lit_end = lit + nlit;

    if (ip >= end) return ZSTD_E_CORRUPT;
    size_t nseq = *ip++;
    if (nseq >= 128) {
        if (nseq == 255) {
            if (end - ip < 2) return ZSTD_E_CORRUPT;
            nseq = le16(ip) + 0x7F00;
            ip += 2;
        } else {
            if (ip >= end) return ZSTD_E_CORRUPT;
            nseq = ((nseq - 128) << 8) + *ip++;
        }
    }
    if (nseq > 0) {
        if (ip >= end) return ZSTD_E_CORRUPT;
        uint8_t modes = *ip++;
        if (modes & 3) return ZSTD_E_RESERVED;
        CHECK(seq_table(&ip, end, modes >> 6, c->ll, &c->ll_log, &c->ll_ok,
                        LL_DEFAULT, 36, 6, LL_MAX_SYM, LL_MAX_LOG));
        CHECK(seq_table(&ip, end, (modes >> 4) & 3, c->of, &c->of_log,
                        &c->of_ok, OF_DEFAULT, 29, 5, OF_MAX_SYM, OF_MAX_LOG));
        CHECK(seq_table(&ip, end, (modes >> 2) & 3, c->ml, &c->ml_log,
                        &c->ml_ok, ML_DEFAULT, 53, 6, ML_MAX_SYM, ML_MAX_LOG));
        bwd_t b;
        CHECK(bwd_init(&b, ip, (size_t)(end - ip)));
        uint32_t sll = (uint32_t)bwd_read(&b, c->ll_log);
        uint32_t sof = (uint32_t)bwd_read(&b, c->of_log);
        uint32_t sml = (uint32_t)bwd_read(&b, c->ml_log);
        size_t *rep = c->rep;
        for (size_t i = 0; i < nseq; i++) {
            const fse_entry eo = c->of[sof], em = c->ml[sml], el = c->ll[sll];
            uint64_t ofv = (1ull << eo.sym) + bwd_read(&b, eo.sym);
            size_t mlen = ML_BASE[em.sym] + (size_t)bwd_read(&b, ML_BITS[em.sym]);
            size_t llen = LL_BASE[el.sym] + (size_t)bwd_read(&b, LL_BITS[el.sym]);
            size_t off;
            if (ofv > 3) {
                off = (size_t)(ofv - 3);
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = off;
            } else {
                /* With no literals the repeat codes shift by one, and
                 * code 3 means the first repeat offset minus one. */
                size_t idx = (size_t)ofv - 1 + (llen == 0);
                if (idx == 0) {
                    off = rep[0];
                } else {
                    off = idx == 3 ? rep[0] - 1 : rep[idx];
                    if (idx != 1) rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = off;
                }
            }
            if (i + 1 < nseq) {
                sll = el.next + (uint32_t)bwd_read(&b, el.nbits);
                sml = em.next + (uint32_t)bwd_read(&b, em.nbits);
                sof = eo.next + (uint32_t)bwd_read(&b, eo.nbits);
            }
            if (b.pos < 0) return ZSTD_E_CORRUPT;
            if (llen > (size_t)(lit_end - lit)) return ZSTD_E_CORRUPT;
            if (llen + mlen > (size_t)(oend - op)) return ZSTD_E_DST_TOO_SMALL;
            memcpy(op, lit, llen);
            op += llen;
            lit += llen;
            if (off == 0 || off > (size_t)(op - frame_start))
                return ZSTD_E_CORRUPT;
            copy_match(op, off, mlen);
            op += mlen;
        }
        if (b.pos != 0) return ZSTD_E_CORRUPT;
    } else if (ip != end) {
        return ZSTD_E_CORRUPT;
    }
    size_t rest = (size_t)(lit_end - lit);
    if (rest > (size_t)(oend - op)) return ZSTD_E_DST_TOO_SMALL;
    memcpy(op, lit, rest);
    op += rest;
    if (op - block_start > BLOCK_MAX) return ZSTD_E_CORRUPT;
    *opp = op;
    return ZSTD_OK;
}

/* ------------------------------------------------------------------ */
/* Frames                                                              */
/* ------------------------------------------------------------------ */

typedef struct {
    size_t header_size;
    int has_size, checksum;
    uint64_t content_size;
} frame_header;

static int read_frame_header(const uint8_t *src, size_t len,
                             frame_header *h) {
    if (len < 5) return ZSTD_E_TRUNCATED;
    const uint8_t fhd = src[4];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
    const int did_flag = fhd & 3;
    if (fhd & 8) return ZSTD_E_RESERVED;
    size_t pos = 5;
    if (!single) pos++; /* window descriptor: the output buffer is the window */
    static const size_t DID_SIZE[4] = {0, 1, 2, 4};
    const size_t did_size = DID_SIZE[did_flag];
    const size_t fcs_size = fcs_flag == 0 ? (size_t)single : (size_t)1 << fcs_flag;
    if (len < pos + did_size + fcs_size) return ZSTD_E_TRUNCATED;
    uint32_t did = 0;
    for (size_t i = 0; i < did_size; i++) did |= (uint32_t)src[pos + i] << (8 * i);
    if (did != 0) return ZSTD_E_DICTIONARY;
    pos += did_size;
    uint64_t fcs = 0;
    for (size_t i = 0; i < fcs_size; i++) fcs |= (uint64_t)src[pos + i] << (8 * i);
    if (fcs_size == 2) fcs += 256;
    pos += fcs_size;
    h->header_size = pos;
    h->has_size = fcs_size > 0;
    h->content_size = fcs;
    h->checksum = (fhd >> 2) & 1;
    return ZSTD_OK;
}

static int decode_frame(dctx *c, const uint8_t *src, size_t len,
                        size_t *consumed, uint8_t *dst, size_t cap,
                        size_t *written) {
    frame_header h;
    CHECK(read_frame_header(src, len, &h));
    const uint8_t *ip = src + h.header_size, *end = src + len;
    c->huf_ok = c->ll_ok = c->of_ok = c->ml_ok = 0;
    c->rep[0] = 1;
    c->rep[1] = 4;
    c->rep[2] = 8;
    uint8_t *op = dst, *const oend = dst + cap;
    for (;;) {
        if (end - ip < 3) return ZSTD_E_TRUNCATED;
        const uint32_t bh = le24(ip);
        ip += 3;
        const int last = bh & 1, type = (bh >> 1) & 3;
        const size_t bsize = bh >> 3;
        if (type == 3) return ZSTD_E_BLOCK_TYPE;
        if (bsize > BLOCK_MAX) return ZSTD_E_CORRUPT;
        if (type == 1) { /* RLE: one byte, repeated bsize times */
            if (end - ip < 1) return ZSTD_E_TRUNCATED;
            if ((size_t)(oend - op) < bsize) return ZSTD_E_DST_TOO_SMALL;
            memset(op, *ip, bsize);
            ip += 1;
            op += bsize;
        } else {
            if ((size_t)(end - ip) < bsize) return ZSTD_E_TRUNCATED;
            if (type == 0) {
                if ((size_t)(oend - op) < bsize) return ZSTD_E_DST_TOO_SMALL;
                memcpy(op, ip, bsize);
                op += bsize;
            } else {
                CHECK(decode_block(c, ip, bsize, dst, &op, oend));
            }
            ip += bsize;
        }
        if (last) break;
    }
    if (h.has_size && (uint64_t)(op - dst) != h.content_size)
        return ZSTD_E_SIZE_MISMATCH;
    if (h.checksum) {
        if (end - ip < 4) return ZSTD_E_TRUNCATED;
        if ((uint32_t)xxh64(dst, (size_t)(op - dst)) != le32(ip))
            return ZSTD_E_CHECKSUM;
        ip += 4;
    }
    *consumed = (size_t)(ip - src);
    *written = (size_t)(op - dst);
    return ZSTD_OK;
}

/* Decodes every frame of src[0, len) (zstd and skippable frames, one after
 * another) into dst, which holds cap bytes; *written is the decoded size. */
int zstd_decompress(const uint8_t *src, size_t len, uint8_t *dst, size_t cap,
                    size_t *written) {
    *written = 0;
    if (len == 0) return ZSTD_E_TRUNCATED;
    dctx *c = (dctx *)malloc(sizeof(dctx));
    if (c == NULL) return ZSTD_E_NO_MEMORY;
    size_t out = 0;
    int rc = ZSTD_OK;
    while (len > 0) {
        if (len < 4) {
            rc = ZSTD_E_TRUNCATED;
            break;
        }
        const uint32_t magic = le32(src);
        if ((magic & SKIPPABLE_MASK) == SKIPPABLE_MAGIC) {
            if (len < 8 || len - 8 < le32(src + 4)) {
                rc = ZSTD_E_TRUNCATED;
                break;
            }
            size_t skip = 8 + (size_t)le32(src + 4);
            src += skip;
            len -= skip;
            continue;
        }
        if (magic != ZSTD_MAGIC) {
            rc = ZSTD_E_MAGIC;
            break;
        }
        size_t used, w;
        rc = decode_frame(c, src, len, &used, dst + out, cap - out, &w);
        if (rc) break;
        src += used;
        len -= used;
        out += w;
    }
    free(c);
    *written = out;
    return rc;
}

/* An upper bound of the decoded size of src[0, len), from the frame and
 * block headers alone: a frame's content size where it records one, else
 * the sum of its blocks' largest decoded sizes.  *exact is 1 when every
 * frame records its size. */
int zstd_decoded_bound(const uint8_t *src, size_t len, uint64_t *bound,
                       int *exact) {
    *bound = 0;
    *exact = 1;
    if (len == 0) return ZSTD_E_TRUNCATED;
    while (len > 0) {
        if (len < 4) return ZSTD_E_TRUNCATED;
        const uint32_t magic = le32(src);
        size_t skip;
        if ((magic & SKIPPABLE_MASK) == SKIPPABLE_MAGIC) {
            if (len < 8 || len - 8 < le32(src + 4)) return ZSTD_E_TRUNCATED;
            skip = 8 + (size_t)le32(src + 4);
        } else {
            if (magic != ZSTD_MAGIC) return ZSTD_E_MAGIC;
            frame_header h;
            CHECK(read_frame_header(src, len, &h));
            size_t pos = h.header_size;
            uint64_t blocks = 0;
            for (;;) {
                if (len - pos < 3) return ZSTD_E_TRUNCATED;
                const uint32_t bh = le24(src + pos);
                pos += 3;
                const int type = (bh >> 1) & 3;
                const size_t bsize = bh >> 3;
                if (type == 3) return ZSTD_E_BLOCK_TYPE;
                if (bsize > BLOCK_MAX) return ZSTD_E_CORRUPT;
                const size_t stored = type == 1 ? 1 : bsize;
                if (len - pos < stored) return ZSTD_E_TRUNCATED;
                pos += stored;
                blocks += type == 2 ? BLOCK_MAX : bsize;
                if (bh & 1) break;
            }
            if (h.checksum) {
                if (len - pos < 4) return ZSTD_E_TRUNCATED;
                pos += 4;
            }
            if (h.has_size) {
                *bound += h.content_size;
            } else {
                *bound += blocks;
                *exact = 0;
            }
            skip = pos;
        }
        src += skip;
        len -= skip;
    }
    return ZSTD_OK;
}
