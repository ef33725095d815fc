// Host entropy-table builders of the encode plane: every lane of a chunk in
// one call.  Built by g++ (not nvcc) into build/host/ and bound with ctypes
// by ``native.get_tables_lib``; the Python builders of ops/device_encode.py
// (``_build_lit_tables_plain``, ``_build_seq_tables_plain``) are the plain
// version, and every output array here equals theirs byte for byte.
//
// The port follows the plain version's call tree and its rules, not
// libzstd's: the two-queue Huffman merge over leaves in (count asc, symbol
// desc) order; the height limit at 11 bits that lengthens the longest,
// then least frequent, of the symbols shorter than 11 bits, and shortens
// the most frequent; the weights FSE-compressed whenever the largest symbol
// is 128 or more; FSE_normalizeCount with its M2 path; the NCount writer;
// FSE_buildCTable; the two-state FSE encode; and the per-symbol transition
// maps of ``_symbol_maps``.
//
// Where the Python raises, the lane is left as the Python leaves it.  The
// helpers return Z_ERR where the Python raises ZstdError and X_ERR where it
// raises anything else (an assertion, an index out of range): the literal
// builder falls back to raw nibble weights on Z_ERR inside the weights'
// compression and skips the lane on X_ERR; the sequence builder keeps a
// channel predefined on either.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

typedef __int128 i128;

enum { OK = 0, Z_ERR = 1, X_ERR = 2 };

constexpr int MIN_TLOG = 5;
constexpr int HUF_MAX_BITS = 11;
const int64_t RTB[8] = {0, 473195, 504333, 520860, 550000, 700000, 750000,
                        830000};

int highbit(int64_t v) { return 63 - __builtin_clzll((uint64_t)v); }

i128 floordiv(i128 a, i128 b) {
    i128 q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

int min_table_log(int64_t src_size, int max_symbol) {
    if (src_size <= 0) return -1;  // the plain version asserts: never here
    int a = highbit(src_size) + 1;
    int b = highbit(max_symbol > 1 ? max_symbol : 1) + 2;
    return a < b ? a : b;
}

// FSE_optimalTableLog_internal with minus = 2 (src_size > 1)
int optimal_table_log(int max_tlog, int64_t src_size, int max_symbol) {
    int max_bits_src = highbit(src_size - 1) - 2;
    int tl = max_tlog ? max_tlog : 11;
    tl = std::min(tl, max_bits_src);
    tl = std::max(tl, min_table_log(src_size, max_symbol));
    tl = std::max(tl, 5);
    return std::min(tl, 12);
}

// FSE_normalizeM2, low_prob 1; norm holds int64 values
int normalize_m2(int64_t* norm, int tlog, const int64_t* count,
                 int64_t total, int max_symbol) {
    const int64_t NOT_YET = -2;
    int64_t distributed = 0;
    int64_t low_threshold = total >> tlog;
    i128 low_one = ((i128)total * 3) >> (tlog + 1);
    for (int s = 0; s <= max_symbol; s++) {
        int64_t c = count[s];
        if (c == 0) {
            norm[s] = 0;
        } else if (c <= low_threshold) {
            norm[s] = 1;
            distributed++;
            total -= c;
        } else if (c <= low_one) {
            norm[s] = 1;
            distributed++;
            total -= c;
        } else {
            norm[s] = NOT_YET;
        }
    }
    int64_t to_distribute = ((int64_t)1 << tlog) - distributed;
    if (to_distribute == 0) return OK;
    if (floordiv(total, to_distribute) > low_one) {
        low_one = floordiv((i128)total * 3, (i128)to_distribute * 2);
        for (int s = 0; s <= max_symbol; s++) {
            if (norm[s] == NOT_YET && count[s] <= low_one) {
                norm[s] = 1;
                distributed++;
                total -= count[s];
            }
        }
        to_distribute = ((int64_t)1 << tlog) - distributed;
    }
    if (distributed == max_symbol + 1) {
        int max_v = 0;
        for (int s = 1; s <= max_symbol; s++)
            if (count[s] > count[max_v]) max_v = s;
        norm[max_v] += to_distribute;
        return OK;
    }
    if (total == 0) {
        bool any = false;
        for (int s = 0; s <= max_symbol; s++) any |= norm[s] > 0;
        if (to_distribute > 0 && !any) return X_ERR;  // the plain one spins
        int s = 0;
        while (to_distribute > 0) {
            if (norm[s] > 0) {
                to_distribute--;
                norm[s]++;
            }
            s = (s + 1) % (max_symbol + 1);
        }
        return OK;
    }
    int v_step_log = 62 - tlog;
    i128 mid = ((i128)1 << (v_step_log - 1)) - 1;
    i128 r_step = floordiv(((i128)1 << v_step_log) * to_distribute + mid,
                           total);
    i128 tmp_total = mid;
    for (int s = 0; s <= max_symbol; s++) {
        if (norm[s] == NOT_YET) {
            i128 end = tmp_total + (i128)count[s] * r_step;
            i128 weight = (end >> v_step_log) - (tmp_total >> v_step_log);
            if (weight < 1) return Z_ERR;
            norm[s] = (int64_t)weight;
            tmp_total = end;
        }
    }
    int64_t sum = 0;
    for (int s = 0; s <= max_symbol; s++) sum += norm[s];
    return sum != 0 ? OK : X_ERR;
}

// FSE_normalizeCount, use_low_prob false: norm[0..max_symbol]
int normalize_count(int64_t* norm, const int64_t* count, int tlog,
                    int64_t total, int max_symbol) {
    if (tlog < 5 || tlog > 12) return Z_ERR;
    if (tlog < min_table_log(total, max_symbol)) return Z_ERR;
    int scale = 62 - tlog;
    i128 step = ((i128)1 << 62) / total;
    i128 v_step = (i128)1 << (scale - 20);
    int64_t still = (int64_t)1 << tlog;
    int largest = 0;
    int64_t largest_p = 0;
    int64_t low_threshold = total >> tlog;
    for (int s = 0; s <= max_symbol; s++) {
        int64_t c = count[s];
        if (c == total) return Z_ERR;
        if (c == 0) {
            norm[s] = 0;
            continue;
        }
        if (c <= low_threshold) {
            norm[s] = 1;
            still -= 1;
        } else {
            i128 cs = (i128)c * step;
            int64_t proba = (int64_t)(cs >> scale);
            if (proba < 8) {
                i128 rest_to_beat = v_step * RTB[proba];
                if (cs - ((i128)proba << scale) > rest_to_beat) proba++;
            }
            if (proba > largest_p) {
                largest_p = proba;
                largest = s;
            }
            norm[s] = proba;
            still -= proba;
        }
    }
    if (-still >= (norm[largest] >> 1)) {
        int st = normalize_m2(norm, tlog, count, total, max_symbol);
        if (st != OK) return st;
    } else {
        norm[largest] += still;
    }
    int64_t abs_sum = 0;
    for (int s = 0; s <= max_symbol; s++)
        abs_sum += norm[s] < 0 ? -norm[s] : norm[s];
    return abs_sum <= ((int64_t)1 << tlog) ? OK : X_ERR;
}

// FSE_writeNCount: the header into out (room for 1024 bytes), its length
// into *len
int write_ncount(const int64_t* norm, int max_symbol, int tlog, uint8_t* out,
                 int* len) {
    uint64_t acc = 0;
    int bit_count = 0, n = 0;
    auto push = [&](int64_t value, int nbits) {
        acc |= ((uint64_t)value & (((uint64_t)1 << nbits) - 1)) << bit_count;
        bit_count += nbits;
        while (bit_count >= 16) {
            out[n++] = (uint8_t)(acc & 0xFF);
            out[n++] = (uint8_t)((acc >> 8) & 0xFF);
            acc >>= 16;
            bit_count -= 16;
        }
    };
    int64_t table_size = (int64_t)1 << tlog;
    push(tlog - MIN_TLOG, 4);
    int64_t remaining = table_size + 1, threshold = table_size;
    int nb_bits = tlog + 1;
    int symbol = 0;
    bool previous_is_0 = false;
    while (remaining > 1) {
        if (n > 1000) return X_ERR;
        if (previous_is_0) {
            int start = symbol;
            while (symbol <= max_symbol && norm[symbol] == 0) symbol++;
            if (symbol > max_symbol) return Z_ERR;  // trailing zeros
            while (symbol >= start + 24) {
                start += 24;
                push(0xFFFF, 16);
            }
            while (symbol >= start + 3) {
                start += 3;
                push(3, 2);
            }
            push(symbol - start, 2);
        }
        if (symbol > max_symbol) return X_ERR;  // an index past the norm
        int64_t count = norm[symbol++];
        int64_t cap = 2 * threshold - 1 - remaining;
        remaining -= count < 0 ? -count : count;
        count += 1;
        if (count >= threshold) count += cap;
        push(count, count >= cap ? nb_bits : nb_bits - 1);
        previous_is_0 = count == 1;
        if (remaining < 1) return Z_ERR;
        while (remaining < threshold) {
            nb_bits--;
            threshold >>= 1;
        }
    }
    while (bit_count > 0) {
        out[n++] = (uint8_t)(acc & 0xFF);
        acc >>= 8;
        bit_count -= 8;
    }
    if (symbol > max_symbol + 1) return Z_ERR;
    *len = n;
    return OK;
}

// FSE_buildCTable: st [1 << tlog] (state numbers, tableSize + u), dnb and
// dfs [max_symbol + 1].  normalize_count never gives a low-probability
// (-1) count here (low_prob is 1), so the spread is the plain stride walk.
int build_ctable(const int64_t* norm, int max_symbol, int tlog,
                 uint16_t* st, uint32_t* dnb, int32_t* dfs) {
    const int TS = 1 << tlog, mask = TS - 1;
    const int step = (TS >> 1) + (TS >> 3) + 3;
    int64_t cumul[256], next[256], total = 0;
    for (int s = 0; s <= max_symbol; s++) {
        if (norm[s] < 0) return X_ERR;
        cumul[s] = next[s] = total;
        total += norm[s];
    }
    if (total != TS) return X_ERR;
    uint8_t sym[4096];
    int64_t i = 0;
    for (int s = 0; s <= max_symbol; s++)
        for (int64_t k = 0; k < norm[s]; k++, i++)
            sym[(i * step) & mask] = (uint8_t)s;
    for (int u = 0; u < TS; u++) st[next[sym[u]]++] = (uint16_t)(TS + u);
    for (int s = 0; s <= max_symbol; s++) {
        int64_t nv = norm[s], d_nb, d_fs = 0;
        if (nv == 0) {
            d_nb = ((int64_t)(tlog + 1) << 16) - TS;
        } else if (nv == 1) {
            d_nb = ((int64_t)tlog << 16) - TS;
            d_fs = cumul[s] - 1;
        } else {
            int mbo = tlog - highbit(nv - 1);
            d_nb = ((int64_t)mbo << 16) - (nv << mbo);
            d_fs = cumul[s] - nv;
        }
        dnb[s] = (uint32_t)d_nb;
        dfs[s] = (int32_t)d_fs;
    }
    return OK;
}

// FSE_compress_usingCTable: the two-state encode of sym[0..n) (n > 1),
// back to front, into out (room for 1024 bytes)
int fse_compress(const uint8_t* sym, int n, const uint16_t* st,
                 const uint32_t* dnb, const int32_t* dfs, int tlog,
                 uint8_t* out, int* len) {
    const int64_t TS = (int64_t)1 << tlog;
    uint64_t acc = 0;
    int nbits = 0, o = 0;
    bool bad = false;
    auto add = [&](uint64_t value, int64_t nb) {
        if (nb > 32 || o > 1000) {
            bad = true;
            return;
        }
        acc |= (value & (((uint64_t)1 << nb) - 1)) << nbits;
        nbits += (int)nb;
        while (nbits >= 8) {
            out[o++] = (uint8_t)(acc & 0xFF);
            acc >>= 8;
            nbits -= 8;
        }
    };
    auto state_at = [&](int64_t idx) -> int64_t {
        if (idx < 0) idx += TS;  // numpy's negative index
        if (idx < 0 || idx >= TS) {
            bad = true;
            return TS;
        }
        return st[idx];
    };
    auto init = [&](int s) -> int64_t {
        int64_t nb_out = ((int64_t)dnb[s] + (1 << 15)) >> 16;
        int64_t value = (nb_out << 16) - (int64_t)dnb[s];
        return state_at((value >> nb_out) + dfs[s]);
    };
    auto encode = [&](int64_t& value, int s) {
        int64_t nb_out = (value + (int64_t)dnb[s]) >> 16;
        add((uint64_t)value, nb_out);
        value = state_at((value >> nb_out) + dfs[s]);
    };
    int ip = n;
    int64_t c1, c2;
    if (n & 1) {
        c1 = init(sym[ip - 1]);
        c2 = init(sym[ip - 2]);
        encode(c1, sym[ip - 3]);
        ip -= 3;
    } else {
        c2 = init(sym[ip - 1]);
        c1 = init(sym[ip - 2]);
        ip -= 2;
    }
    if ((n - 2) & 2) {
        encode(c2, sym[ip - 1]);
        encode(c1, sym[ip - 2]);
        ip -= 2;
    }
    while (ip > 0) {
        encode(c2, sym[ip - 1]);
        encode(c1, sym[ip - 2]);
        encode(c2, sym[ip - 3]);
        encode(c1, sym[ip - 4]);
        ip -= 4;
    }
    add((uint64_t)c2, tlog);
    add((uint64_t)c1, tlog);
    add(1, 1);  // the end mark
    if (nbits) out[o++] = (uint8_t)(acc & (((uint64_t)1 << nbits) - 1));
    if (bad) return X_ERR;
    *len = o;
    return OK;
}

// ---------------------------------------------------------------------------
// Huffman literal tables
// ---------------------------------------------------------------------------

// Optimal code lengths by the two-queue merge over the leaves sorted by
// (count asc, symbol desc): lengths[0..max_symbol], and that order of the
// n present symbols in leaf[0..n)
int huffman_lengths(const int64_t* counts, int max_symbol, int* lengths,
                    int* leaf) {
    uint64_t keys[256];
    int n = 0;
    for (int s = 0; s <= max_symbol; s++) {
        lengths[s] = 0;
        if (counts[s] != 0)
            keys[n++] = ((uint64_t)counts[s] << 8) | (uint64_t)(255 - s);
    }
    std::sort(keys, keys + n);
    int64_t weight[511];
    int parent[511], depth[511];
    for (int i = 0; i < n; i++) {
        weight[i] = (int64_t)(keys[i] >> 8);
        leaf[i] = 255 - (int)(keys[i] & 0xFF);
    }
    int li = 0, ii = n, next_node = n;
    for (int k = 0; k < n - 1; k++) {
        int picks[2];
        for (int j = 0; j < 2; j++) {
            if (li < n && (ii >= next_node || weight[li] <= weight[ii]))
                picks[j] = li++;
            else
                picks[j] = ii++;
        }
        weight[next_node] = weight[picks[0]] + weight[picks[1]];
        parent[picks[0]] = next_node;
        parent[picks[1]] = next_node;
        next_node++;
    }
    depth[2 * n - 2] = 0;
    for (int node = 2 * n - 3; node >= 0; node--)
        depth[node] = depth[parent[node]] + 1;
    for (int i = 0; i < n; i++) lengths[leaf[i]] = depth[i];
    return n;
}

// Height-limit the lengths to max_bits, keeping Kraft's equality; leaf
// holds the n present symbols in (count asc, symbol desc) order.  While in
// debt, the plain version lengthens, among the symbols shorter than
// max_bits whose gain fits the debt (all of them when none fits), the
// longest, then the least frequent, then the first.  The longest have the
// smallest gain, so they fit whenever any symbol does: the pick is the
// first symbol of the longest length in (count asc, symbol asc) order.  In
// credit it shortens the first symbol, in (count desc, symbol asc) order,
// whose cost fits.
int limit_lengths(int* len, const int64_t* counts, const int* leaf, int n,
                  int max_bits) {
    int64_t debt = -((int64_t)1 << max_bits);
    int at[32] = {0};  // symbols shorter than max_bits at each length
    int up[256], n_up = 0;  // those symbols, count asc, then symbol asc
    for (int i = 0; i < n; i++) {
        int s = leaf[i];
        if (len[s] > max_bits) len[s] = max_bits;
        debt += (int64_t)1 << (max_bits - len[s]);
    }
    for (int i = 0; i < n;) {  // each run of equal counts, reversed
        int e = i;
        while (e < n && counts[leaf[e]] == counts[leaf[i]]) e++;
        for (int k = e - 1; k >= i; k--) {
            if (len[leaf[k]] < max_bits) {
                at[len[leaf[k]]]++;
                up[n_up++] = leaf[k];
            }
        }
        i = e;
    }
    while (debt > 0) {
        int longest = 0;
        for (int l = max_bits - 1; l > 0 && !longest; l--)
            if (at[l]) longest = l;
        if (!longest) return X_ERR;
        int i = 0;
        while (len[up[i]] != longest) i++;
        const int best = up[i];
        at[longest]--;
        if (++len[best] < max_bits) {
            at[len[best]]++;
        } else {  // no longer a candidate
            std::memmove(up + i, up + i + 1, (n_up - i - 1) * sizeof(up[0]));
            n_up--;
        }
        debt -= (int64_t)1 << (max_bits - len[best]);
    }
    while (debt < 0) {
        int best = -1;
        for (int i = n - 1; i >= 0 && best < 0; i--) {
            int s = leaf[i];
            if (len[s] > 1 && ((int64_t)1 << (max_bits - len[s])) <= -debt)
                best = s;
        }
        if (best < 0) return X_ERR;
        len[best]--;
        debt += (int64_t)1 << (max_bits - len[best] - 1);
    }
    return OK;
}

// HUF_writeCTable as the plain version's write_ctable: the descriptor
// into d (room for 1024 bytes), its length into *dlen
int write_ctable(const int* nb, int max_symbol, int table_log, uint8_t* d,
                 int* dlen) {
    uint8_t wt[256];
    const int m = max_symbol;  // the last symbol's weight is implied
    for (int s = 0; s < m; s++)
        wt[s] = (uint8_t)(nb[s] > 0 ? table_log + 1 - nb[s] : 0);
    uint8_t payload[1024];
    int plen = -1;
    if (m > 1) {
        int64_t cnt[16] = {0};
        for (int s = 0; s < m; s++) cnt[wt[s]]++;
        int64_t max_count = 0;
        int max_sym_w = 0;
        for (int w = 0; w < 16; w++) {
            if (cnt[w] > max_count) max_count = cnt[w];
            if (cnt[w]) max_sym_w = w;
        }
        if (max_count < m && max_count > 1) {
            int tlog = optimal_table_log(6, m, max_sym_w);
            int64_t norm[16];
            uint16_t st[4096];
            uint32_t dnb[16];
            int32_t dfs[16];
            int hlen = 0, blen = 0;
            int rc = normalize_count(norm, cnt, tlog, m, max_sym_w);
            if (rc == OK) rc = write_ncount(norm, max_sym_w, tlog, payload,
                                            &hlen);
            if (rc == OK) rc = build_ctable(norm, max_sym_w, tlog, st, dnb,
                                            dfs);
            if (rc == OK) rc = fse_compress(wt, m, st, dnb, dfs, tlog,
                                            payload + hlen, &blen);
            if (rc == X_ERR) return X_ERR;
            if (rc == OK) plen = hlen + blen;
        }
    }
    if (plen > 1 && plen < 128 &&
        (2 * plen < max_symbol || max_symbol >= 128)) {
        d[0] = (uint8_t)plen;
        std::memcpy(d + 1, payload, plen);
        *dlen = plen + 1;
        return OK;
    }
    if (max_symbol >= 128) return Z_ERR;  // raw weights need maxSymbol<128
    d[0] = (uint8_t)(128 + max_symbol - 1);
    int np_ = (m + 1) / 2;
    for (int i = 0; i < np_; i++) {
        int hi = wt[2 * i], lo = 2 * i + 1 < m ? wt[2 * i + 1] : 0;
        d[1 + i] = (uint8_t)((hi << 4) | lo);
    }
    *dlen = 1 + np_;
    return OK;
}

// One lane's literal table: codes and nbits [256] (zero past the largest
// symbol), the descriptor; false where the lane stays raw or RLE
bool lit_lane(const int32_t* hist, int64_t n, uint32_t* codes,
              uint32_t* nbits, uint8_t* desc, int32_t* desc_len,
              int64_t desc_max) {
    int64_t counts[256];
    int nnz = 0, max_symbol = -1;
    int64_t cmax = hist[0];
    for (int s = 0; s < 256; s++) {
        counts[s] = hist[s];
        if (counts[s] > cmax) cmax = counts[s];
        if (counts[s] != 0) {
            nnz++;
            max_symbol = s;
        }
    }
    if (n < 64 || nnz < 2 || cmax >= n) return false;
    int len[256], leaf[256];
    const int n_leaf = huffman_lengths(counts, max_symbol, len, leaf);
    int lmax = 0;
    for (int s = 0; s <= max_symbol; s++) lmax = std::max(lmax, len[s]);
    if (lmax > HUF_MAX_BITS) {
        if (limit_lengths(len, counts, leaf, n_leaf, HUF_MAX_BITS) != OK)
            return false;
        lmax = 0;
        for (int s = 0; s <= max_symbol; s++) lmax = std::max(lmax, len[s]);
    }
    const int table_log = lmax;
    int64_t nb_per_rank[64] = {0}, val_per_rank[64] = {0};
    for (int s = 0; s <= max_symbol; s++)
        if (len[s] > 0) nb_per_rank[len[s]]++;
    int64_t mn = 0;
    for (int l = table_log; l > 0; l--) {
        val_per_rank[l] = mn;
        mn += nb_per_rank[l];
        mn >>= 1;
    }
    uint8_t d[1024];
    int dlen = 0;
    if (write_ctable(len, max_symbol, table_log, d, &dlen) != OK) return false;
    if (dlen > desc_max) return false;
    for (int s = 0; s <= max_symbol; s++) {
        int l = len[s];
        codes[s] = l ? (uint32_t)(uint16_t)val_per_rank[l]++ : 0;
        nbits[s] = (uint32_t)(uint8_t)l;
    }
    std::memcpy(desc, d, dlen);
    *desc_len = dlen;
    return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// Sequence (FSE) tables
// ---------------------------------------------------------------------------

// One channel of the sequence tables: the lanes' code histograms and the
// predefined rows in, the [B, nsym, TS] maps and nbs, [B, nsym] init and
// [B] flush out (ctypes mirror: native.SeqChannel)
struct ZtSeqChannel {
    const int32_t* hist;      // [B, nbins]
    int64_t nbins, nsym, tlog;
    const int32_t* pre_maps;  // [nsym, TS]
    const uint8_t* pre_nbs;   // [nsym, TS]
    const int32_t* pre_init;  // [nsym]
    int32_t* maps;
    uint8_t* nbs;
    int32_t* init;
    int32_t* flush;
};

namespace {

void seq_predefined(const ZtSeqChannel& c, int64_t b) {
    const int64_t TS = (int64_t)1 << c.tlog, rows = c.nsym * TS;
    std::memcpy(c.maps + b * rows, c.pre_maps, rows * sizeof(int32_t));
    std::memcpy(c.nbs + b * rows, c.pre_nbs, rows);
    std::memcpy(c.init + b * c.nsym, c.pre_init, c.nsym * sizeof(int32_t));
    c.flush[b] = (int32_t)c.tlog;
}

// _symbol_maps of a fresh table over rows 0..max_sym of lane b
void seq_symbol_maps(const ZtSeqChannel& c, int64_t b, int max_sym,
                     const uint16_t* state_table, const uint32_t* dnb32,
                     const int32_t* dfs) {
    const int64_t TS = (int64_t)1 << c.tlog;
    int32_t* maps = c.maps + b * c.nsym * TS;
    uint8_t* nbs = c.nbs + b * c.nsym * TS;
    int32_t* init = c.init + b * c.nsym;
    // the state of each row's index clipped into [0, TS), less TS
    auto state = [&](int64_t i) {
        return (int32_t)(state_table[i < 0 ? 0 : std::min(i, TS - 1)] - TS);
    };
    for (int s = 0; s <= max_sym; s++) {
        const int64_t dnb = (int32_t)dnb32[s], d_fs = dfs[s];
        for (int64_t u = 0; u < TS; u++) {
            int64_t val = TS + u;
            int64_t nb = (val + dnb) >> 16;
            maps[s * TS + u] = state((val >> nb) + d_fs);
            nbs[s * TS + u] = (uint8_t)nb;
        }
        int64_t nb0 = (dnb + (1 << 15)) >> 16;
        int64_t v0 = (nb0 << 16) - dnb;
        init[s] = state((v0 >> nb0) + d_fs);
    }
}

}  // namespace

extern "C" {

// The literal Huffman tables of every lane (``_build_lit_tables``):
// lit_hist [B, 256], lit_count [B] in; codes, nbits [B, 256], desc [B,
// desc_max], desc_len [B], huf_ok [B] out, every byte written.  Returns the
// number of lanes with a Huffman table.
int64_t zt_build_lit_tables(int64_t B, const int32_t* lit_hist,
                            const int32_t* lit_count, uint32_t* codes,
                            uint32_t* nbits, uint8_t* desc, int32_t* desc_len,
                            uint8_t* huf_ok, int64_t desc_max) {
    int64_t n_ok = 0;
    for (int64_t b = 0; b < B; b++) {
        uint32_t* cb = codes + b * 256;
        uint32_t* nbb = nbits + b * 256;
        uint8_t* db = desc + b * desc_max;
        std::memset(cb, 0, 256 * sizeof(uint32_t));
        std::memset(nbb, 0, 256 * sizeof(uint32_t));
        std::memset(db, 0, desc_max);
        desc_len[b] = 0;
        bool ok = lit_lane(lit_hist + b * 256, lit_count[b], cb, nbb, db,
                           desc_len + b, desc_max);
        if (!ok) {
            std::memset(cb, 0, 256 * sizeof(uint32_t));
            std::memset(nbb, 0, 256 * sizeof(uint32_t));
            desc_len[b] = 0;
        }
        huf_ok[b] = ok;
        n_ok += ok;
    }
    return n_ok;
}

// The sequence FSE tables of every lane (``_build_seq_tables``) at the
// channels' default table logs: chans [3] (ll, of, ml), nseq [B] in;
// each channel's rows, mode_byte [B], tbl [B, tbl_max], tbl_len [B] out,
// every byte written.  Returns 0, or -1 - b where lane b's fresh table
// would have more rows than the channel (the plain version raises there).
int64_t zt_build_seq_tables(int64_t B, const int32_t* nseq,
                            const ZtSeqChannel* chans, int64_t tbl_max,
                            int32_t* mode_byte, uint8_t* tbl,
                            int32_t* tbl_len) {
    for (int64_t b = 0; b < B; b++) {
        for (int ci = 0; ci < 3; ci++) seq_predefined(chans[ci], b);
        std::memset(tbl + b * tbl_max, 0, tbl_max);
        mode_byte[b] = 0;
        tbl_len[b] = 0;
        const int64_t n = nseq[b];
        if (n < 32) continue;
        uint8_t area[3 * 1024];
        int area_len = 0;
        int modes[3] = {0, 0, 0};
        for (int ci = 0; ci < 3; ci++) {
            const ZtSeqChannel& c = chans[ci];
            const int32_t* h = c.hist + b * c.nbins;
            int64_t counts[256];
            int nnz = 0, max_sym = -1;
            for (int s = 0; s < c.nbins; s++) {
                counts[s] = h[s];
                if (counts[s] != 0) {
                    nnz++;
                    max_sym = s;
                }
            }
            const int64_t TS = (int64_t)1 << c.tlog;
            if (nnz == 1) {  // RLE: a zero-width channel
                modes[ci] = 1;
                area[area_len++] = (uint8_t)max_sym;
                std::memset(c.maps + b * c.nsym * TS, 0,
                            c.nsym * TS * sizeof(int32_t));
                std::memset(c.nbs + b * c.nsym * TS, 0, c.nsym * TS);
                std::memset(c.init + b * c.nsym, 0,
                            c.nsym * sizeof(int32_t));
                c.flush[b] = 0;
                continue;
            }
            if (nnz == 0) continue;
            int64_t norm[256];
            uint8_t hdr[1024];
            uint16_t st[4096];
            uint32_t dnb[256];
            int32_t dfs[256];
            int hlen = 0;
            const int tlog = (int)c.tlog;
            if (normalize_count(norm, counts, tlog, n, max_sym) != OK ||
                write_ncount(norm, max_sym, tlog, hdr, &hlen) != OK ||
                build_ctable(norm, max_sym, tlog, st, dnb, dfs) != OK)
                continue;
            if (max_sym >= c.nsym) return -1 - b;
            modes[ci] = 2;
            std::memcpy(area + area_len, hdr, hlen);
            area_len += hlen;
            seq_symbol_maps(c, b, max_sym, st, dnb, dfs);
        }
        if (area_len > tbl_max || (!modes[0] && !modes[1] && !modes[2])) {
            for (int ci = 0; ci < 3; ci++) seq_predefined(chans[ci], b);
            continue;
        }
        mode_byte[b] = (modes[0] << 6) | (modes[1] << 4) | (modes[2] << 2);
        std::memcpy(tbl + b * tbl_max, area, area_len);
        tbl_len[b] = area_len;
    }
    return 0;
}

}  // extern "C"
