// Native anchor-extraction kernel: 2-bit k-mer packing + sort + merge join.
//
// C++ counterpart of the hot host-side path of the chained long-sequence
// mode (chain/anchors.py), replacing the reference's Rust k-mer
// machinery (lib_ts_chainalign/src/anchors/kmers.rs, kmer_matches.rs:32-76).
// Exposed via a plain C ABI consumed with ctypes.
//
// Build: compiled lazily by chain/native.py (g++ -O3 -shared -fPIC) into
// tsalign_tpu_torch/_build/, under the hash of this source.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Entry {
    uint64_t code;
    int64_t pos;
    bool operator<(const Entry& o) const {
        return code < o.code || (code == o.code && pos < o.pos);
    }
};

// Pack every k-mer of seq (values 0..3, other values poison the window).
void pack(const int8_t* seq, int64_t n, int64_t k, std::vector<Entry>& out) {
    out.clear();
    if (n < k || k <= 0) return;
    out.reserve(n - k + 1);
    uint64_t code = 0;
    const uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
    int64_t bad_run = 0;  // chars since last poison
    for (int64_t i = 0; i < n; ++i) {
        int8_t c = seq[i];
        if (c < 0 || c > 3) {
            bad_run = 0;
            code = 0;
            continue;
        }
        code = ((code << 2) | static_cast<uint64_t>(c)) & mask;
        ++bad_run;
        if (bad_run >= k) {
            out.push_back(Entry{code, i - k + 1});
        }
    }
}

}  // namespace

extern "C" {

// Returns the number of anchor pairs; fills *out_ri / *out_qi with malloc'd
// arrays the caller must release via tsa_free.  Returns -1 if the join
// would exceed max_out.
int64_t tsa_kmer_anchors(const int8_t* ref, int64_t n_ref, const int8_t* qry,
                         int64_t n_qry, int64_t k, int64_t max_out,
                         int64_t** out_ri, int64_t** out_qi) {
    std::vector<Entry> a, b;
    pack(ref, n_ref, k, a);
    pack(qry, n_qry, k, b);
    std::sort(a.begin(), a.end());
    std::sort(b.begin(), b.end());

    // count pass
    int64_t total = 0;
    size_t i = 0, j = 0;
    while (i < a.size() && j < b.size()) {
        if (a[i].code < b[j].code) {
            ++i;
        } else if (b[j].code < a[i].code) {
            ++j;
        } else {
            uint64_t c = a[i].code;
            size_t i2 = i, j2 = j;
            while (i2 < a.size() && a[i2].code == c) ++i2;
            while (j2 < b.size() && b[j2].code == c) ++j2;
            total += static_cast<int64_t>(i2 - i) * static_cast<int64_t>(j2 - j);
            if (total > max_out) return -1;
            i = i2;
            j = j2;
        }
    }

    int64_t* ri = static_cast<int64_t*>(malloc(sizeof(int64_t) * total));
    int64_t* qi = static_cast<int64_t*>(malloc(sizeof(int64_t) * total));
    int64_t w = 0;
    i = 0;
    j = 0;
    while (i < a.size() && j < b.size()) {
        if (a[i].code < b[j].code) {
            ++i;
        } else if (b[j].code < a[i].code) {
            ++j;
        } else {
            uint64_t c = a[i].code;
            size_t i2 = i, j2 = j;
            while (i2 < a.size() && a[i2].code == c) ++i2;
            while (j2 < b.size() && b[j2].code == c) ++j2;
            for (size_t x = i; x < i2; ++x) {
                for (size_t y = j; y < j2; ++y) {
                    ri[w] = a[x].pos;
                    qi[w] = b[y].pos;
                    ++w;
                }
            }
            i = i2;
            j = j2;
        }
    }
    *out_ri = ri;
    *out_qi = qi;
    return total;
}

void tsa_free(void* p) { free(p); }

}  // extern "C"

extern "C" {

// Windowed co-linear chain DP over anchors sorted by (ref, qry).
// score[a] = k*match_score + max over previous `window` anchors of
// score[b] + gain - gap_cost (see chain/chain.py, the numpy
// spec).  Writes the best chain's anchor indices into out_idx (capacity
// n) and returns the chain length.
int64_t tsa_chain(const int64_t* ri, const int64_t* qi, int64_t n, int64_t k,
                  int64_t match_score, int64_t window, int64_t max_gap,
                  int64_t drift_unit, int64_t* out_idx) {
    if (n == 0) return 0;
    std::vector<int64_t> score(n), parent(n, -1);
    for (int64_t a = 0; a < n; ++a) {
        score[a] = k * match_score;
        int64_t lo = a - window;
        if (lo < 0) lo = 0;
        int64_t best = score[a];
        int64_t bestp = -1;
        for (int64_t b = lo; b < a; ++b) {
            int64_t di = ri[a] - ri[b];
            int64_t dj = qi[a] - qi[b];
            if (di <= 0 || dj <= 0 || di >= max_gap || dj >= max_gap) continue;
            int64_t mn = di < dj ? di : dj;
            int64_t overlap = k - mn;
            if (overlap < 0) overlap = 0;
            int64_t gain = k - overlap;
            int64_t drift = di - dj;
            if (drift < 0) drift = -drift;
            int64_t cand = score[b] + gain * match_score - drift * drift_unit - mn / 8;
            if (cand > best) {
                best = cand;
                bestp = b;
            }
        }
        if (bestp >= 0) {
            score[a] = best;
            parent[a] = bestp;
        }
    }
    int64_t argmax = 0;
    for (int64_t a = 1; a < n; ++a)
        if (score[a] > score[argmax]) argmax = a;
    int64_t len = 0;
    for (int64_t a = argmax; a >= 0; a = parent[a]) ++len;
    int64_t w = len;
    for (int64_t a = argmax; a >= 0; a = parent[a]) out_idx[--w] = a;
    return len;
}

}  // extern "C"
