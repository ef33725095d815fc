// The decode plane's block walk of multi-block frames: every block of every
// multi-block frame of a batch in one call.  Built by g++ (not nvcc) into
// build/host/ and bound with ctypes by ``native.get_mb_lib``; the Python
// walk ``_plan_multiblock`` of decode/device_pipeline.py is the plain
// version, and the plan made here equals its plan: the same pool bytes and
// Huffman lanes in the same order, the same block rows, frames and host
// sequence rows.
//
// A frame's walk follows the plain version's rules.  A Huffman literal
// section takes kernel lanes when it has its own tree of at most ``maxlog``
// bits and its streams fit the kernel (4 streams of at most huf_maxw words
// each, or 1 stream of at most 4,096 symbols); every other Huffman section
// (treeless, a 12-bit tree, a wide stream) is decoded here into the raw
// pool.  The sequence sections are decoded here, the repeat tables and the
// repeat offsets carried from block to block, so the executor's rounds get
// resolved offsets.
//
// A frame is taken whole or not at all.  Where the plain version would
// raise or route the frame, and wherever this walk is unsure that the plain
// version would take the frame as it does (a section it declines to read),
// the frame is refused: its pool bytes, lanes and rows are taken back and
// the call stops there, so the caller plans that frame in Python, which
// gives its route.  Where a buffer runs out, the frame is taken back too and
// the call stops, so the caller grows the buffer and calls again from that
// frame.

#include <chrono>
#include <cstdint>
#include <cstring>

extern "C" {

// Mirror of ZtDPlaneCtx (native/zstdtpu_core.cpp; native.DPlaneCtx): the
// planner's caller-owned operand buffers and counters.
struct ZtDPlaneCtx {
    int64_t pool_cap, pool_off;
    int64_t huf_cap, n_huf;
    int64_t fse_cap, n_fse;
    int64_t huf_maxw, fse_maxw;
    int64_t s_cap;
    int64_t huf_wmax, fse_wmax;
    int64_t max_seq, max_out;
    uint8_t* raw_pool;
    uint32_t* huf_words;
    int32_t* huf_limits;
    int32_t* huf_bases;
    int32_t* huf_offs;
    int32_t* huf_shifts;
    int32_t* huf_planes;
    int32_t* huf_pos;
    int32_t* huf_nsym;
    int32_t* huf_wlen;
    uint32_t* fse_words;
    int32_t* fse_ll;
    int32_t* fse_of;
    int32_t* fse_ml;
    int32_t* fse_logs;
    int32_t* fse_pos;
    int32_t* fse_rep;
    int32_t* fse_nseq;
    int32_t* fse_wlen;
    int32_t* fse_st;
};

// One call's limits in, its rows out (native.MbOut).
//   frames [n, MB_FCOLS]: first block row, blocks, content size, stored
//     checksum (-1 if none), window, regenerated literal bytes of the
//     compressed blocks, those decoded here, treeless sections decoded here
//   blocks [blk_cap, MB_BCOLS]: out_len, out_off, lit_regen, lit_kind,
//     pool_base, pool_len, huf_lane0, huf_seg, seq_kind, n_seq, first
//     sequence row (-1 if none)
//   ll, ml, of [seq_cap]: the decoded sequences, offsets resolved
struct ZtMbOut {
    int64_t maxlog, content_cap, window_cap;
    int64_t* frames;
    int64_t* blocks;
    uint32_t* ll;
    uint32_t* ml;
    uint32_t* of;
    int64_t blk_cap, seq_cap;
    int64_t n_blocks, n_seqs;   // rows used
    int64_t seq_ns;             // steady-clock ns of the sequence decodes
    int64_t stop;               // MB_DONE, MB_REFUSED or MB_ROOM
    int64_t room;               // MB_ROOM: the buffers that ran out
    int64_t want_pool, want_huf, want_blocks, want_seqs;
};

}  // extern "C"

namespace {

enum { MB_DONE = 0, MB_REFUSED = 1, MB_ROOM = 2 };
enum { R_POOL = 1, R_HUF = 2, R_BLOCKS = 4, R_SEQS = 8 };
enum { MB_FCOLS = 8, MB_BCOLS = 11 };

inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

// ---------------------------------------------------------------------------
// Sequence codes and predefined distributions (RFC 8878 3.1.1.3.2.1.1, 4)
// ---------------------------------------------------------------------------

const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 0x80, 0x100, 0x200, 0x400,
    0x800, 0x1000, 0x2000, 0x4000, 0x8000, 0x10000};
const uint8_t LL_BITS[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_NORM[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const uint32_t ML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t ML_NORM[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
    -1, -1, -1, -1, -1};
const int16_t OF_NORM[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    -1, -1, -1, -1, -1};

struct SeqCodes {
    uint32_t base[53];
    uint8_t bits[53];
    int max_sym;   // the largest code a table may hold
    int max_log;   // the largest table log a header may give
};

// A sequence decode table cell: the code's base value and extra bits, then
// the state's bits and next-state base (ZSTD_seqSymbol).
struct SeqCell {
    uint32_t base;
    uint8_t add;
    uint8_t nb;
    uint16_t ns;
};

struct SeqTable {
    int tlog;
    SeqCell cell[512];
};

// ---------------------------------------------------------------------------
// FSE tables (entropy/fse.py: read_ncount, _spread_symbols, build_dtable)
// ---------------------------------------------------------------------------

// Bits [lo, lo + 57) of the stream p[0, len), zero outside it.
inline uint64_t load_bits(const uint8_t* p, int64_t len, int64_t lo) {
    const int64_t b = lo >> 3;
    uint64_t w;
    if (b >= 0 && b + 8 <= len) {
        std::memcpy(&w, p + b, 8);
    } else {
        w = 0;
        for (int k = 0; k < 8; k++) {
            const int64_t j = b + k;
            if (j >= 0 && j < len) w |= (uint64_t)p[j] << (8 * k);
        }
    }
    return w >> (lo & 7);
}

// The normalized counts of an NCount header (forward bits); bytes read, or
// -1 where read_ncount raises.
int64_t read_ncount(const uint8_t* src, int64_t len, int max_sym_limit,
                    int max_tlog, int16_t* norm, int* max_sym, int* tlog_out) {
    if (len < 1) return -1;
    auto field = [&](int64_t bitpos, int n) -> uint32_t {
        return (uint32_t)(load_bits(src, len, bitpos) & ((1u << n) - 1));
    };
    const int64_t lim = len * 8 + 7;
    int64_t bitpos = 4;
    const int tlog = (int)field(0, 4) + 5;
    if (tlog > max_tlog) return -1;
    int remaining = (1 << tlog) + 1, threshold = 1 << tlog, nb_bits = tlog + 1;
    std::memset(norm, 0, sizeof(int16_t) * (max_sym_limit + 1));
    int charnum = 0;
    bool previous0 = false;
    while (remaining > 1 && charnum <= max_sym_limit) {
        if (previous0) {
            int n0 = charnum;
            while (field(bitpos, 16) == 0xFFFF) {
                n0 += 24;
                bitpos += 16;
                if (bitpos > lim || n0 > 4096) return -1;
            }
            while (field(bitpos, 2) == 3) {
                n0 += 3;
                bitpos += 2;
                if (bitpos > lim) return -1;
            }
            n0 += (int)field(bitpos, 2);
            bitpos += 2;
            if (n0 > max_sym_limit) return -1;
            charnum = n0;
        }
        const int cap = 2 * threshold - 1 - remaining;
        int count = (int)field(bitpos, nb_bits);
        if ((count & (threshold - 1)) < cap) {
            count &= threshold - 1;
            bitpos += nb_bits - 1;
        } else {
            if (count >= threshold) count -= cap;
            bitpos += nb_bits;
        }
        count -= 1;
        remaining -= count < 0 ? -count : count;
        norm[charnum++] = (int16_t)count;
        previous0 = count == 0;
        while (remaining < threshold) {
            nb_bits--;
            threshold >>= 1;
        }
        if (bitpos > lim) return -1;
    }
    if (remaining != 1 || bitpos > len * 8) return -1;
    *max_sym = charnum - 1;
    *tlog_out = tlog;
    return (bitpos + 7) >> 3;
}

// The symbol spread of a table (low-probability symbols at the top, the
// others by the stride walk); false where the walk does not close.
bool spread(const int16_t* norm, int max_sym, int tlog, uint8_t* tsym) {
    const int size = 1 << tlog, mask = size - 1;
    const int step = (size >> 1) + (size >> 3) + 3;
    int high = size - 1;
    for (int s = 0; s <= max_sym; s++)
        if (norm[s] == -1) tsym[high--] = (uint8_t)s;
    int pos = 0;
    for (int s = 0; s <= max_sym; s++)
        for (int i = 0; i < norm[s]; i++) {
            tsym[pos] = (uint8_t)s;
            do pos = (pos + step) & mask; while (pos > high);
        }
    return pos == 0;
}

// Each cell's state bits and next-state base, in table order.
template <class F>
void fill_states(const int16_t* norm, int max_sym, int tlog,
                 const uint8_t* tsym, F put) {
    const int size = 1 << tlog;
    uint32_t next[256];
    for (int s = 0; s <= max_sym; s++)
        next[s] = norm[s] == -1 ? 1 : (norm[s] > 0 ? (uint32_t)norm[s] : 0);
    for (int u = 0; u < size; u++) {
        const uint32_t ns = next[tsym[u]]++;
        const int nb = tlog - highbit(ns);
        put(u, tsym[u], nb, (uint16_t)((ns << nb) - (uint32_t)size));
    }
}

bool build_seq_table(const int16_t* norm, int max_sym, int tlog,
                     const SeqCodes& codes, SeqTable* t) {
    uint8_t tsym[512];
    if (!spread(norm, max_sym, tlog, tsym)) return false;
    t->tlog = tlog;
    fill_states(norm, max_sym, tlog, tsym,
                [&](int u, int s, int nb, uint16_t ns) {
                    t->cell[u] = {codes.base[s], codes.bits[s], (uint8_t)nb,
                                  ns};
                });
    return true;
}

struct Codes {
    SeqCodes ll, of, ml;
    SeqTable ll_def, of_def, ml_def;
};

// The three channels' codes and predefined tables, built once (a
// magic static: the shard threads of the parallel pipeline may plan at the
// same time).
const Codes& codes() {
    static const Codes* c = [] {
        Codes* k = new Codes();
        std::memset(k, 0, sizeof(Codes));
        for (int s = 0; s < 36; s++) {
            k->ll.base[s] = LL_BASE[s];
            k->ll.bits[s] = LL_BITS[s];
        }
        for (int s = 0; s < 53; s++) {
            k->ml.base[s] = ML_BASE[s];
            k->ml.bits[s] = ML_BITS[s];
        }
        for (int s = 0; s < 32; s++) {
            k->of.base[s] = s < 2 ? (uint32_t)s : (1u << s) - 3;
            k->of.bits[s] = (uint8_t)s;
        }
        k->ll.max_sym = 35; k->ll.max_log = 9;
        k->ml.max_sym = 52; k->ml.max_log = 9;
        k->of.max_sym = 31; k->of.max_log = 8;
        build_seq_table(LL_NORM, 35, 6, k->ll, &k->ll_def);
        build_seq_table(ML_NORM, 52, 6, k->ml, &k->ml_def);
        build_seq_table(OF_NORM, 28, 5, k->of, &k->of_def);
        return k;
    }();
    return *c;
}

// ---------------------------------------------------------------------------
// Huffman (entropy/huffman.py: read_weights, build_dtable, decode_1x/_4x)
// ---------------------------------------------------------------------------

// Backward reader over a short stream copied behind 16 zero bytes.
struct SmallReader {
    uint8_t buf[16 + 128 + 8];
    int64_t pos;
    bool init(const uint8_t* p, int64_t len) {
        if (len <= 0 || len > 128 || p[len - 1] == 0) return false;
        std::memset(buf, 0, sizeof buf);
        std::memcpy(buf + 16, p, (size_t)len);
        pos = (len - 1) * 8 + highbit(p[len - 1]);
        return true;
    }
    uint32_t read(int n) {
        pos -= n;
        const int64_t q = pos + 128;
        if (q < 0) return 0;
        uint64_t w;
        std::memcpy(&w, buf + (q >> 3), 8);
        return (uint32_t)((w >> (q & 7)) & ((1u << n) - 1));
    }
};

// A tree's weights, the implied last one appended; header bytes read, or -1
// where read_weights raises.  w holds 258 entries.
int64_t read_weights(const uint8_t* src, int64_t len, uint8_t* w, int* nsym,
                     int* tlog_out) {
    if (len < 1) return -1;
    const int i_size = src[0];
    int64_t consumed;
    int o_size;
    if (i_size >= 128) {
        o_size = i_size - 127;
        consumed = (o_size + 1) / 2 + 1;
        if (len < consumed) return -1;
        for (int i = 0; i < o_size; i++) {
            const uint8_t b = src[1 + i / 2];
            w[i] = (i & 1) ? (b & 15) : (b >> 4);
        }
    } else {
        consumed = i_size + 1;
        if (len < consumed) return -1;
        const uint8_t* payload = src + 1;
        int16_t norm[13];
        int max_sym = 0, tl = 0;
        const int64_t h = read_ncount(payload, i_size, 12, 6, norm, &max_sym,
                                      &tl);
        if (h < 0) return -1;
        uint8_t tsym[64], nbb[64];
        uint16_t nst[64];
        if (!spread(norm, max_sym, tl, tsym)) return -1;
        fill_states(norm, max_sym, tl, tsym,
                    [&](int u, int, int nb, uint16_t ns) {
                        nbb[u] = (uint8_t)nb;
                        nst[u] = ns;
                    });
        SmallReader r;
        if (!r.init(payload + h, i_size - h)) return -1;
        uint32_t s1 = r.read(tl), s2 = r.read(tl);
        o_size = 0;
        for (;;) {
            if (o_size > 254) return -1;
            w[o_size++] = tsym[s1];
            s1 = nst[s1] + r.read(nbb[s1]);
            if (r.pos < 0) { w[o_size++] = tsym[s2]; break; }
            w[o_size++] = tsym[s2];
            s2 = nst[s2] + r.read(nbb[s2]);
            if (r.pos < 0) { w[o_size++] = tsym[s1]; break; }
        }
    }
    if (o_size < 1) return -1;
    uint64_t total = 0;
    for (int i = 0; i < o_size; i++) {
        if (w[i] > 12) return -1;
        if (w[i]) total += 1ull << (w[i] - 1);
    }
    if (total == 0) return -1;
    const int tlog = highbit(total) + 1;
    if (tlog > 12) return -1;
    const uint64_t rest = (1ull << tlog) - total;
    if (rest & (rest - 1)) return -1;
    w[o_size] = (uint8_t)(highbit(rest) + 1);
    *nsym = o_size + 1;
    *tlog_out = tlog;
    return consumed;
}

// The single-symbol decode table: cell = symbol | bits << 8.
struct HufTable {
    int tlog;
    uint16_t cell[1 << 12];
};

void build_huf_table(const uint8_t* w, int nsym, int tlog, HufTable* t) {
    int start[14] = {0};
    for (int s = 0; s < nsym; s++)
        if (w[s]) start[w[s]] += 1 << (w[s] - 1);
    int acc = 0;
    for (int k = 1; k <= tlog; k++) {
        const int n = start[k];
        start[k] = acc;
        acc += n;
    }
    for (int s = 0; s < nsym; s++) {
        if (!w[s]) continue;
        const uint16_t c = (uint16_t)(s | ((tlog + 1 - w[s]) << 8));
        for (int j = 0; j < (1 << (w[s] - 1)); j++) t->cell[start[w[s]]++] = c;
    }
    t->tlog = tlog;
}

// One backward stream of n symbols into out; true iff it is read exactly
// to its first bit (decode_stream and the 1X / 4X consumption checks).
bool huf_stream(const uint8_t* p, int64_t len, const HufTable& t,
                uint8_t* out, int64_t n) {
    if (len <= 0 || p[len - 1] == 0) return false;
    int64_t pos = (len - 1) * 8 + highbit(p[len - 1]);
    const int tlog = t.tlog;
    const uint64_t mask = (1ull << tlog) - 1;
    const int per = 57 / tlog;
    int64_t i = 0;
    while (i + per <= n && pos >= 64) {
        const int64_t base = pos - 57;
        uint64_t w;
        std::memcpy(&w, p + (base >> 3), 8);
        w >>= base & 7;
        int rel = 57;
        for (int k = 0; k < per; k++) {
            const uint16_t c = t.cell[(w >> (rel - tlog)) & mask];
            out[i++] = (uint8_t)c;
            rel -= c >> 8;
        }
        pos = base + rel;
    }
    for (; i < n; i++) {
        if (pos < 0) return false;
        const uint16_t c = t.cell[load_bits(p, len, pos - tlog) & mask];
        out[i] = (uint8_t)c;
        pos -= c >> 8;
    }
    return pos == 0;
}

// A literal section's Huffman streams (1 or 4) decoded on the host.  The
// four streams of a section first advance together, a window of symbols
// each in turn, so their table reads overlap; each then ends alone.
bool huf_section(const uint8_t* s, int64_t len, bool four, const HufTable& t,
                 uint8_t* out, int64_t regen) {
    if (!four) return huf_stream(s, len, t, out, regen);
    if (len < 10) return false;
    const int64_t l1 = s[0] | (s[1] << 8), l2 = s[2] | (s[3] << 8),
                  l3 = s[4] | (s[5] << 8);
    const int64_t b[5] = {6, 6 + l1, 6 + l1 + l2, 6 + l1 + l2 + l3, len};
    if (b[3] > len) return false;
    const int64_t seg = (regen + 3) / 4;
    const int64_t sizes[4] = {seg, seg, seg, regen - 3 * seg};
    if (sizes[3] < 0) return false;
    const int tlog = t.tlog;
    const uint64_t mask = (1ull << tlog) - 1;
    const int per = 57 / tlog;
    int64_t pos[4], done = 0;
    for (int k = 0; k < 4; k++) {
        const int64_t n = b[k + 1] - b[k];
        if (n <= 0 || s[b[k + 1] - 1] == 0) return false;
        pos[k] = (n - 1) * 8 + highbit(s[b[k + 1] - 1]);
    }
    for (;;) {
        bool go = done + per <= sizes[3];
        for (int k = 0; k < 4; k++) go = go && pos[k] >= 64;
        if (!go) break;
        uint64_t w[4];
        int rel[4];
        int64_t base[4];
        for (int k = 0; k < 4; k++) {
            base[k] = pos[k] - 57;
            std::memcpy(&w[k], s + b[k] + (base[k] >> 3), 8);
            w[k] >>= base[k] & 7;
            rel[k] = 57;
        }
        for (int j = 0; j < per; j++)
            for (int k = 0; k < 4; k++) {
                const uint16_t c = t.cell[(w[k] >> (rel[k] - tlog)) & mask];
                out[k * seg + done + j] = (uint8_t)c;
                rel[k] -= c >> 8;
            }
        for (int k = 0; k < 4; k++) pos[k] = base[k] + rel[k];
        done += per;
    }
    for (int k = 0; k < 4; k++) {
        const int64_t n = b[k + 1] - b[k];
        const uint8_t* p = s + b[k];
        uint8_t* o = out + k * seg;
        for (int64_t i = done; i < sizes[k]; i++) {
            if (pos[k] < 0) return false;
            const uint16_t c = t.cell[load_bits(p, n, pos[k] - tlog) & mask];
            o[i] = (uint8_t)c;
            pos[k] -= c >> 8;
        }
        if (pos[k] != 0) return false;
    }
    return true;
}

// ---------------------------------------------------------------------------
// Sequences (decode/block.py: decode_sequence_headers, decode_sequences)
// ---------------------------------------------------------------------------

// One channel's table from the sequence section header: predefined, RLE,
// FSE-coded or repeated.  Bytes read, or -1.
int64_t seq_table(int mode, const uint8_t* src, int64_t len,
                  const SeqCodes& codes, const SeqTable* def, SeqTable* own,
                  const SeqTable** cur) {
    if (mode == 0) {
        *cur = def;
        return 0;
    }
    if (mode == 1) {
        if (len < 1 || src[0] > codes.max_sym) return -1;
        own->tlog = 0;
        own->cell[0] = {codes.base[src[0]], codes.bits[src[0]], 0, 0};
        *cur = own;
        return 1;
    }
    if (mode == 2) {
        int16_t norm[64];
        int max_sym = 0, tlog = 0;
        const int64_t h = read_ncount(src, len, codes.max_sym, codes.max_log,
                                      norm, &max_sym, &tlog);
        if (h < 0 || !build_seq_table(norm, max_sym, tlog, codes, own))
            return -1;
        *cur = own;
        return h;
    }
    return *cur ? 0 : -1;
}

// nseq sequences of the backward stream p[0, len), offsets resolved through
// rep (updated); false unless the stream is read exactly to its first bit.
// Each sequence starts with a fresh 57-bit window, which holds its fields
// unless its offset is long; the match and literal lengths' extra bits
// are read as one field, and so are the three state updates' bits (the
// order they lie in the stream).  *match gets the sum of the match
// lengths.
bool decode_seqs(const uint8_t* p, int64_t len, int64_t nseq,
                 const SeqTable& LL, const SeqTable& OF, const SeqTable& ML,
                 uint32_t* rep, uint32_t* oll, uint32_t* oml, uint32_t* oof,
                 uint64_t* match) {
    if (len <= 0 || p[len - 1] == 0) return false;
    // win holds the stream's bits [top - 57, top), of which the low bl are
    // unread: the next field ends at bit top - 57 + bl
    int64_t top = (len - 1) * 8 + highbit(p[len - 1]) + 57;
    uint64_t win = 0;
    int bl = 0;
    auto reload = [&] {
        top += bl - 57;
        const int64_t lo = top - 57;
        if (lo >= 0) {
            std::memcpy(&win, p + (lo >> 3), 8);
            win >>= lo & 7;
        } else {
            win = load_bits(p, len, lo);
        }
        bl = 57;
    };
    auto take = [&](int n) -> uint32_t {
        bl -= n;
        return (uint32_t)((win >> bl) & ((1ull << n) - 1));
    };
    reload();
    uint32_t sll = take(LL.tlog), sof = take(OF.tlog), sml = take(ML.tlog);
    uint32_t r0 = rep[0], r1 = rep[1], r2 = rep[2];
    uint64_t sum = 0;
    for (int64_t i = 0; i < nseq; i++) {
        const SeqCell cl = LL.cell[sll], co = OF.cell[sof], cm = ML.cell[sml];
        reload();
        uint32_t offset;
        if (co.add > 1) {
            offset = co.base + take(co.add);
            r2 = r1;
            r1 = r0;
            r0 = offset;
        } else {
            const uint32_t ll0 = cl.base == 0;
            if (co.add == 0) {
                offset = ll0 ? r1 : r0;
                if (ll0) { const uint32_t t = r0; r0 = r1; r1 = t; }
            } else {
                const uint32_t idx = co.base + ll0 + take(1);
                uint32_t t = idx == 3 ? r0 - 1 : (idx == 1 ? r1 : r2);
                if (t == 0) t = 1;
                if (idx != 1) r2 = r1;
                r1 = r0;
                r0 = offset = t;
            }
        }
        const int nl = cm.add + cl.add;
        if (__builtin_expect(bl < nl, 0)) reload();
        const uint32_t v = take(nl);
        const uint32_t ml = cm.base + (v >> cl.add);
        oll[i] = cl.base + (v & ((1u << cl.add) - 1));
        oml[i] = ml;
        oof[i] = offset;
        sum += ml;
        if (i != nseq - 1) {
            const int ns = cl.nb + cm.nb + co.nb;
            if (__builtin_expect(bl < ns, 0)) reload();
            const uint32_t u = take(ns);
            sof = co.ns + (u & ((1u << co.nb) - 1));
            sml = cm.ns + ((u >> co.nb) & ((1u << cm.nb) - 1));
            sll = cl.ns + (u >> (co.nb + cm.nb));
        }
        if (top - 57 + bl < 0) return false;
    }
    if (top - 57 + bl != 0) return false;
    *match = sum;
    rep[0] = r0;
    rep[1] = r1;
    rep[2] = r2;
    return true;
}

// ---------------------------------------------------------------------------
// Huffman kernel lanes (zt_dplane_pack_huf's layout)
// ---------------------------------------------------------------------------

// Pack one stream as a lane: its words and the canonical arithmetic of the
// tree (weights with the implied last one).  The lane, or -1 where the
// packer refuses the stream (empty, a zero last byte, too wide).
int64_t pack_huf_lane(ZtDPlaneCtx* c, const uint8_t* p, int64_t len,
                      const uint8_t* weights, int nsym_w, int tlog,
                      int64_t n_out) {
    if (tlog < 1 || tlog > 11 || nsym_w < 1 || nsym_w > 256) return -1;
    if (len <= 0 || p[len - 1] == 0) return -1;
    const int64_t nw = (len + 3) >> 2;
    if (nw > c->huf_maxw) return -1;
    const int64_t lane = c->n_huf;
    uint32_t* row = c->huf_words + lane * c->huf_maxw;
    row[nw - 1] = 0;
    std::memcpy(row, p, (size_t)len);
    const int sc = 11 - tlog;
    int32_t lim[16], bas[16], off[16], shf[16];
    for (int k = 0; k < 16; k++) {
        lim[k] = 1 << 11;
        bas[k] = off[k] = shf[k] = 0;
    }
    uint32_t planes[8][8] = {{0}};
    int rank = 0;
    int64_t cum = 0;
    for (int w = 1; w <= tlog; w++) {
        const int64_t start_w = cum;
        const int base_r = rank;
        for (int s = 0; s < nsym_w && rank < 256; s++)
            if (weights[s] == w) {
                for (int j = 0; j < 8; j++)
                    if ((s >> j) & 1) planes[j][rank >> 5] |= 1u << (rank & 31);
                rank++;
            }
        cum += (int64_t)(rank - base_r) << (w - 1);
        lim[w - 1] = (int32_t)(cum << sc);
        bas[w - 1] = base_r;
        off[w - 1] = (int32_t)(start_w << sc);
        shf[w - 1] = (w - 1) + sc;
    }
    std::memcpy(c->huf_limits + lane * 16, lim, sizeof lim);
    std::memcpy(c->huf_bases + lane * 16, bas, sizeof bas);
    std::memcpy(c->huf_offs + lane * 16, off, sizeof off);
    std::memcpy(c->huf_shifts + lane * 16, shf, sizeof shf);
    std::memcpy(c->huf_planes + lane * 64, planes, sizeof planes);
    c->huf_pos[lane] = (int32_t)((len - 1) * 8 + highbit(p[len - 1]));
    c->huf_nsym[lane] = (int32_t)n_out;
    c->huf_wlen[lane] = (int32_t)nw;
    if (nw > c->huf_wmax) c->huf_wmax = nw;
    c->n_huf++;
    return lane;
}

// ---------------------------------------------------------------------------
// The frame walk
// ---------------------------------------------------------------------------

// A frame's entropy state and the walk's scratch.
struct Walk {
    HufTable huf;
    bool has_huf;
    uint8_t weights[258];
    SeqTable own_ll, own_of, own_ml;
    const SeqTable *ll, *of, *ml;
    uint32_t rep[3];
};

struct Frame {
    ZtDPlaneCtx* c;
    ZtMbOut* o;
    int64_t pool0, huf0, hwmax0, blk0, seq0;

    // a result that stops the call: the frame is taken back
    int stop(int why, int room = 0) {
        if (why == MB_ROOM) {
            o->room = room;
            o->want_pool = c->pool_off - pool0;
            o->want_huf = c->n_huf - huf0;
            o->want_blocks = o->n_blocks - blk0;
            o->want_seqs = o->n_seqs - seq0;
        }
        c->pool_off = pool0;
        c->n_huf = huf0;
        c->huf_wmax = hwmax0;
        o->n_blocks = blk0;
        o->n_seqs = seq0;
        return why;
    }
};

struct Header {
    int64_t size, content, window;
    bool checksum;
};

// The frame header as parse_frame_header reads it; false where it raises
// or the frame is not a dictionary-less frame with a content size.
bool parse_header(const uint8_t* f, int64_t n, Header* h) {
    if (n < 6) return false;
    uint32_t magic;
    std::memcpy(&magic, f, 4);
    if (magic != 0xFD2FB528u) return false;
    const int fhd = f[4];
    if ((fhd >> 3) & 1) return false;
    const bool single = (fhd >> 5) & 1;
    const int fcs_code = fhd >> 6;
    int64_t p = 5;
    uint64_t window = 0;
    if (!single) {
        if (n <= p) return false;
        const int wlog = 10 + (f[p] >> 3);
        if (wlog > 31) return false;
        const uint64_t wbase = 1ull << wlog;
        window = wbase + (wbase >> 3) * (f[p] & 7);
        p += 1;
    }
    static const int did_size[4] = {0, 1, 2, 4};
    const int did = did_size[fhd & 3];
    if (n < p + did) return false;
    uint32_t dict_id = 0;
    if (did) std::memcpy(&dict_id, f + p, (size_t)did);
    p += did;
    static const int fcs_size[4] = {0, 2, 4, 8};
    const int fs = fcs_code == 0 && single ? 1 : fcs_size[fcs_code];
    if (n < p + fs || fs == 0 || dict_id != 0) return false;
    uint64_t fcs = 0;
    std::memcpy(&fcs, f + p, (size_t)fs);
    if (fs == 2) fcs += 256;
    p += fs;
    if (fcs > (1ull << 40) || window > (1ull << 40)) return false;
    h->size = p;
    h->content = (int64_t)fcs;
    h->window = single ? (int64_t)fcs : (int64_t)window;
    h->checksum = (fhd >> 2) & 1;
    return true;
}

// Walk one frame's blocks; MB_DONE with its rows written, else a stop.
int plan_frame(ZtDPlaneCtx* c, ZtMbOut* o, const uint8_t* f, int64_t n,
               int64_t* frow, Walk& wk) {
    Frame fr{c, o, c->pool_off, c->n_huf, c->huf_wmax, o->n_blocks,
             o->n_seqs};
    const Codes& k = codes();
    Header hd;
    if (!parse_header(f, n, &hd)) return fr.stop(MB_REFUSED);
    const int64_t content = hd.content;
    if (content > o->content_cap ||
        (content > (1 << 17) && hd.window > o->window_cap))
        return fr.stop(MB_REFUSED);
    wk.has_huf = false;
    wk.ll = wk.of = wk.ml = nullptr;
    wk.rep[0] = 1;
    wk.rep[1] = 4;
    wk.rep[2] = 8;
    int64_t lit_bytes = 0, host_lit_bytes = 0, treeless_host = 0;
    int64_t p = hd.size, out_off = 0;
    // the pool's next bytes, or null where it is full
    auto pool = [&](int64_t len) -> uint8_t* {
        if (c->pool_off + len > c->pool_cap) return nullptr;
        uint8_t* d = c->raw_pool + c->pool_off;
        c->pool_off += len;
        return d;
    };
    for (bool first = true;; first = false) {
        if (p + 3 > n) return fr.stop(MB_REFUSED);
        const uint32_t bh = f[p] | (f[p + 1] << 8) | (f[p + 2] << 16);
        const bool last = bh & 1;
        const int btype = (bh >> 1) & 3;
        const int64_t bsize = bh >> 3;
        if (first && last) return fr.stop(MB_REFUSED);  // single block
        p += 3;
        const int64_t body_len = btype == 1 ? 1 : bsize;
        if (p + body_len > n || btype == 3) return fr.stop(MB_REFUSED);
        if (o->n_blocks >= o->blk_cap) return fr.stop(MB_ROOM, R_BLOCKS);
        int64_t* b = o->blocks + o->n_blocks * MB_BCOLS;
        // out_len, out_off, lit_regen, lit_kind, pool_base, pool_len,
        // huf_lane0, huf_seg, seq_kind, n_seq, first sequence row
        int64_t row[MB_BCOLS] = {0, out_off, 0, 0, 0, 0, -1, 0, 0, 0, -1};
        const uint8_t* body = f + p;
        if (btype < 2) {
            const int64_t plen = btype == 0 ? bsize : 1;
            uint8_t* d = pool(plen);
            if (!d) return fr.stop(MB_ROOM, R_POOL);
            std::memcpy(d, body, (size_t)plen);
            row[4] = d - c->raw_pool;
            row[5] = plen;
            row[2] = row[0] = bsize;
        } else {
            const int64_t plen = bsize;
            if (plen < 1) return fr.stop(MB_REFUSED);
            // the literal section header (_parse_lit_header)
            const int b0 = body[0], lt = b0 & 3, sf = (b0 >> 2) & 3;
            auto le = [&](int nb) {
                uint64_t v = 0;
                for (int j = 0; j < nb && j < plen; j++)
                    v |= (uint64_t)body[j] << (8 * j);
                return v;
            };
            int64_t regen, comp = 0, lh;
            if (lt < 2) {
                if (sf == 0 || sf == 2) { regen = b0 >> 3; lh = 1; }
                else if (sf == 1) { regen = le(2) >> 4; lh = 2; }
                else { regen = le(3) >> 4; lh = 3; }
            } else if (sf < 2) {
                const uint64_t v = le(3);
                regen = (v >> 4) & 0x3FF; comp = (v >> 14) & 0x3FF; lh = 3;
            } else if (sf == 2) {
                const uint64_t v = le(4);
                regen = (v >> 4) & 0x3FFF; comp = (v >> 18) & 0x3FFF; lh = 4;
            } else {
                const uint64_t v = le(5);
                regen = (v >> 4) & 0x3FFFF; comp = (v >> 22) & 0x3FFFF; lh = 5;
            }
            if (lh + comp > plen) return fr.stop(MB_REFUSED);
            row[2] = regen;
            lit_bytes += regen;
            int64_t lit_end;
            if (lt < 2) {
                const int64_t take = lt == 0 ? regen : 1;
                if (lh + take >= plen) return fr.stop(MB_REFUSED);
                uint8_t* d = pool(take);
                if (!d) return fr.stop(MB_ROOM, R_POOL);
                std::memcpy(d, body + lh, (size_t)take);
                row[4] = d - c->raw_pool;
                row[5] = take;
                lit_end = lh + take;
            } else {
                const uint8_t* sec = body + lh;
                int64_t whdr = 0;
                int nsym = 0, tlog = 0;
                bool lanes_ok = false;
                if (lt == 2) {
                    whdr = read_weights(sec, comp, wk.weights, &nsym, &tlog);
                    if (whdr < 0 || nsym > 256) return fr.stop(MB_REFUSED);
                    build_huf_table(wk.weights, nsym, tlog, &wk.huf);
                    wk.has_huf = true;
                    lanes_ok = tlog <= o->maxlog;
                } else if (!wk.has_huf) {
                    return fr.stop(MB_REFUSED);
                }
                const uint8_t* st = sec + whdr;
                const int64_t slen = comp - whdr;
                const int64_t maxb = c->huf_maxw * 4;
                bool taken = false;
                if (lanes_ok && sf != 0 && slen >= 10) {
                    const int64_t s1 = st[0] | (st[1] << 8),
                                  s2 = st[2] | (st[3] << 8),
                                  s3 = st[4] | (st[5] << 8);
                    const int64_t sz[4] = {s1, s2, s3, slen - 6 - s1 - s2 - s3};
                    const int64_t seg = (regen + 3) / 4;
                    const int64_t outs[4] = {seg, seg, seg, regen - 3 * seg};
                    bool fit = true;
                    for (int j = 0; j < 4; j++)
                        fit = fit && sz[j] > 0 && outs[j] > 0 && sz[j] <= maxb;
                    if (fit) {
                        if (c->n_huf + 4 > c->huf_cap)
                            return fr.stop(MB_ROOM, R_HUF);
                        row[6] = c->n_huf;
                        row[7] = seg;
                        int64_t off = 6;
                        for (int j = 0; j < 4; j++) {
                            if (pack_huf_lane(c, st + off, sz[j], wk.weights,
                                              nsym, tlog, outs[j]) < 0)
                                return fr.stop(MB_REFUSED);
                            off += sz[j];
                        }
                        taken = true;
                    }
                } else if (lanes_ok && sf == 0 && slen > 0 && slen <= maxb &&
                           regen > 0 && regen <= 4096) {
                    if (c->n_huf + 1 > c->huf_cap)
                        return fr.stop(MB_ROOM, R_HUF);
                    row[6] = c->n_huf;
                    row[7] = regen;
                    if (pack_huf_lane(c, st, slen, wk.weights, nsym, tlog,
                                      regen) < 0)
                        return fr.stop(MB_REFUSED);
                    taken = true;
                }
                if (taken) {
                    row[3] = 1;
                } else {
                    // decode_literals on the host (it reads 5 header bytes)
                    if (plen < 5) return fr.stop(MB_REFUSED);
                    uint8_t* d = pool(regen);
                    if (!d) return fr.stop(MB_ROOM, R_POOL);
                    if (!huf_section(st, slen, sf != 0, wk.huf, d, regen))
                        return fr.stop(MB_REFUSED);
                    row[4] = d - c->raw_pool;
                    row[5] = regen;
                    host_lit_bytes += regen;
                    treeless_host += lt == 3;
                }
                lit_end = lh + comp;
            }
            // the sequence section (decode_sequence_headers)
            const uint8_t* rest = body + lit_end;
            const int64_t rlen = plen - lit_end;
            if (rlen < 1) return fr.stop(MB_REFUSED);
            int64_t nbseq, q;
            if (rest[0] < 128) { nbseq = rest[0]; q = 1; }
            else if (rest[0] < 255) {
                if (rlen < 2) return fr.stop(MB_REFUSED);
                nbseq = ((rest[0] - 128) << 8) + rest[1]; q = 2;
            } else {
                if (rlen < 3) return fr.stop(MB_REFUSED);
                nbseq = rest[1] + (rest[2] << 8) + 0x7F00; q = 3;
            }
            row[9] = nbseq;
            if (nbseq > 0) {
                if (rlen < q + 1) return fr.stop(MB_REFUSED);
                const int mode = rest[q++];
                if (mode & 3) return fr.stop(MB_REFUSED);
                const SeqTable* ll = wk.ll;
                const SeqTable* of = wk.of;
                const SeqTable* ml = wk.ml;
                int64_t h = seq_table(mode >> 6, rest + q, rlen - q, k.ll,
                                      &k.ll_def, &wk.own_ll, &ll);
                if (h < 0) return fr.stop(MB_REFUSED);
                q += h;
                h = seq_table((mode >> 4) & 3, rest + q, rlen - q, k.of,
                              &k.of_def, &wk.own_of, &of);
                if (h < 0) return fr.stop(MB_REFUSED);
                q += h;
                h = seq_table((mode >> 2) & 3, rest + q, rlen - q, k.ml,
                              &k.ml_def, &wk.own_ml, &ml);
                if (h < 0) return fr.stop(MB_REFUSED);
                q += h;
                wk.ll = ll;
                wk.of = of;
                wk.ml = ml;
                if (nbseq > c->s_cap) return fr.stop(MB_REFUSED);
                if (o->n_seqs + nbseq > o->seq_cap)
                    return fr.stop(MB_ROOM, R_SEQS);
                const int64_t s0 = o->n_seqs;
                uint64_t match = 0;
                const auto t0 = std::chrono::steady_clock::now();
                const bool ok = decode_seqs(rest + q, rlen - q, nbseq, *ll,
                                            *of, *ml, wk.rep, o->ll + s0,
                                            o->ml + s0, o->of + s0, &match);
                o->seq_ns += std::chrono::duration_cast<
                    std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0).count();
                if (!ok) return fr.stop(MB_REFUSED);
                o->n_seqs += nbseq;
                row[8] = 2;
                row[10] = s0;
                row[0] = (int64_t)match + regen;
            } else {
                row[0] = regen;
            }
        }
        out_off += row[0];
        if (out_off > content) return fr.stop(MB_REFUSED);
        std::memcpy(b, row, sizeof row);
        o->n_blocks++;
        p += body_len;
        if (last) break;
    }
    if (out_off != content) return fr.stop(MB_REFUSED);
    int64_t cks = -1;
    if (hd.checksum) {
        if (p + 4 > n) return fr.stop(MB_REFUSED);
        uint32_t v;
        std::memcpy(&v, f + p, 4);
        cks = v;
    }
    const int64_t window = hd.window ? hd.window : content;
    const int64_t fv[MB_FCOLS] = {
        fr.blk0, o->n_blocks - fr.blk0, content, cks,
        window < o->window_cap ? window : o->window_cap,
        lit_bytes, host_lit_bytes, treeless_host};
    std::memcpy(frow, fv, sizeof fv);
    return MB_DONE;
}

}  // namespace

extern "C" {

// Walk frames idx[0..n) of the batch buf (frame i spans [offs[i],
// offs[i + 1])) in order.  Returns how many were planned; o->stop says why
// the walk ended: MB_DONE (every frame), MB_REFUSED (frame idx[ret] is the
// Python walk's) or MB_ROOM (frame idx[ret] needs the buffers in o->room
// grown).
int64_t zt_mb_plan(ZtDPlaneCtx* c, const uint8_t* buf, const int64_t* offs,
                   const int64_t* idx, int64_t n, ZtMbOut* o) {
    Walk* wk = new Walk();
    o->n_blocks = o->n_seqs = o->seq_ns = 0;
    o->stop = MB_DONE;
    o->room = 0;
    int64_t i = 0;
    for (; i < n; i++) {
        const int64_t fi = idx[i];
        const int rc = plan_frame(c, o, buf + offs[fi], offs[fi + 1] - offs[fi],
                                  o->frames + i * MB_FCOLS, *wk);
        if (rc != MB_DONE) {
            o->stop = rc;
            break;
        }
    }
    delete wk;
    return i;
}

}  // extern "C"
