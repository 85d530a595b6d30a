// First-party WordPiece trainer + encoder over integer symbol alphabets.
//
// Replaces the reference's Rust `tokenizers==0.13.2` dependency
// (reference musicnlp/trainer/wordpiece_tokenizer.py:312 trains HF's
// WordPieceTrainer over a unicode-char rendering of music tokens).  Here the
// "characters" are the base-vocabulary token ids directly -- no unicode
// detour -- and both training and encoding run natively:
//
//   * training: WordPiece objective (merge the adjacent unit pair maximizing
//     count(ab) / (count(a) * count(b))), implemented incrementally with a
//     lazy max-heap over pair scores so 32k-262k merges stay tractable;
//   * encoding: greedy longest-match-first against a trie, with '##'
//     continuing-form units exactly like HF's WordPiece model.
//
// C ABI (ctypes-friendly): symbols are int32 >= 0; a "word" is a symbol
// sequence; a vocab "unit" is (continuing-flag, symbol sequence).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC wordpiece.cpp -o libwordpiece.so

#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using i64 = long long;

struct Unit {                     // a vocab entry
    std::vector<int32_t> syms;
    bool cont;                    // continuing (##) form?
};

// ---------------------------------------------------------------- training

struct Word {                     // linked-list of unit ids
    std::vector<int32_t> units;   // -1 = deleted slot
    std::vector<int32_t> prev, next;
    int32_t head = 0;
    i64 count = 0;
};

static inline uint64_t pkey(int32_t a, int32_t b) {
    return (uint64_t(uint32_t(a)) << 32) | uint32_t(b);
}

struct HeapEntry {
    double score;
    uint64_t pair;
    i64 cp, ca, cb;               // snapshot for lazy invalidation
    bool operator<(const HeapEntry& o) const {
        if (score != o.score) return score < o.score;
        return pair > o.pair;     // deterministic tie-break: smaller pair wins
    }
};

struct Trainer {
    std::vector<Unit> units;
    std::vector<i64> unit_count;
    std::vector<Word> words;
    std::unordered_map<uint64_t, i64> pair_count;
    std::unordered_map<uint64_t, std::unordered_set<int32_t>> pair_words;
    // unit -> pairs containing it: a merge changes count(a)/count(b), which
    // RAISES the score of every pair containing a or b -- those must be
    // re-pushed or the heap's lazy invalidation misses them (stale entries
    // are only ever too HIGH in a plain lazy scheme; here they can be too low)
    std::unordered_map<int32_t, std::unordered_set<uint64_t>> unit_pairs;
    std::priority_queue<HeapEntry> heap;

    void add_pair(uint64_t p, i64 c, int32_t wid) {
        pair_count[p] += c;
        pair_words[p].insert(wid);
        unit_pairs[int32_t(p >> 32)].insert(p);
        unit_pairs[int32_t(p & 0xffffffffu)].insert(p);
    }

    void push_heap(uint64_t p) {
        auto it = pair_count.find(p);
        if (it == pair_count.end() || it->second <= 0) return;
        int32_t a = int32_t(p >> 32), b = int32_t(p & 0xffffffffu);
        double s = double(it->second) / (double(unit_count[a]) * double(unit_count[b]));
        heap.push({s, p, it->second, unit_count[a], unit_count[b]});
    }
};

}  // namespace

extern "C" {

// Train merges.  Inputs: flattened word symbols + offsets + per-word counts;
// n_base = alphabet size (symbols are in [0, n_base)); n_merges = merged
// units to learn.  Outputs (caller-allocated):
//   out_syms / out_offs (len n_units+1) / out_cont -- the FULL unit table:
//   first 2*n_base alphabet units (initial then continuing form, in symbol
//   order), then learned merges in creation order.
// Returns the number of units written, or -1 on capacity error.
i64 wp_train(const int32_t* syms, const i64* offs, const i64* counts,
             i64 n_words, i64 n_base, i64 n_merges,
             int32_t* out_syms, i64 out_syms_cap,
             i64* out_offs, int8_t* out_cont, i64 out_cap) {
    Trainer tr;
    tr.units.reserve(2 * n_base + n_merges);
    for (i64 s = 0; s < n_base; ++s) tr.units.push_back({{int32_t(s)}, false});
    for (i64 s = 0; s < n_base; ++s) tr.units.push_back({{int32_t(s)}, true});
    tr.unit_count.assign(tr.units.size(), 0);

    tr.words.resize(n_words);
    for (i64 w = 0; w < n_words; ++w) {
        Word& wd = tr.words[w];
        i64 len = offs[w + 1] - offs[w];
        wd.count = counts[w];
        wd.units.resize(len);
        wd.prev.resize(len);
        wd.next.resize(len);
        for (i64 i = 0; i < len; ++i) {
            int32_t sym = syms[offs[w] + i];
            int32_t u = (i == 0) ? sym : int32_t(sym + n_base);
            wd.units[i] = u;
            wd.prev[i] = int32_t(i - 1);
            wd.next[i] = (i + 1 < len) ? int32_t(i + 1) : -1;
            tr.unit_count[u] += wd.count;
        }
        for (i64 i = 0; i + 1 < len; ++i)
            tr.add_pair(pkey(wd.units[i], wd.units[i + 1]), wd.count, int32_t(w));
    }
    for (auto& kv : tr.pair_count) tr.push_heap(kv.first);

    for (i64 m = 0; m < n_merges;) {
        uint64_t best = 0;
        bool found = false;
        while (!tr.heap.empty()) {
            HeapEntry e = tr.heap.top();
            tr.heap.pop();
            auto it = tr.pair_count.find(e.pair);
            if (it == tr.pair_count.end() || it->second <= 0) continue;
            int32_t a = int32_t(e.pair >> 32), b = int32_t(e.pair & 0xffffffffu);
            if (e.cp != it->second || e.ca != tr.unit_count[a] ||
                e.cb != tr.unit_count[b]) {
                tr.push_heap(e.pair);   // stale: re-push with fresh score
                continue;
            }
            best = e.pair;
            found = true;
            break;
        }
        if (!found) break;

        int32_t a = int32_t(best >> 32), b = int32_t(best & 0xffffffffu);
        Unit nu;
        nu.cont = tr.units[a].cont;
        nu.syms = tr.units[a].syms;
        nu.syms.insert(nu.syms.end(), tr.units[b].syms.begin(), tr.units[b].syms.end());
        int32_t nid = int32_t(tr.units.size());
        tr.units.push_back(std::move(nu));
        tr.unit_count.push_back(0);

        std::unordered_set<int32_t> wids;
        std::swap(wids, tr.pair_words[best]);
        std::unordered_set<uint64_t> touched;
        for (int32_t w : wids) {
            Word& wd = tr.words[w];
            for (int32_t i = wd.head; i != -1; i = wd.next[i]) {
                int32_t j = wd.next[i];
                if (j == -1) break;
                if (wd.units[i] != a || wd.units[j] != b) continue;
                int32_t p = wd.prev[i], n = wd.next[j];
                // decrement old pairs
                tr.pair_count[best] -= wd.count;
                if (p != -1) { tr.pair_count[pkey(wd.units[p], a)] -= wd.count;
                               touched.insert(pkey(wd.units[p], a)); }
                if (n != -1) { tr.pair_count[pkey(b, wd.units[n])] -= wd.count;
                               touched.insert(pkey(b, wd.units[n])); }
                // merge j into i
                wd.units[i] = nid;
                wd.next[i] = n;
                if (n != -1) wd.prev[n] = i;
                wd.units[j] = -1;
                tr.unit_count[a] -= wd.count;
                tr.unit_count[b] -= wd.count;
                tr.unit_count[nid] += wd.count;
                // increment new pairs
                if (p != -1) { tr.add_pair(pkey(wd.units[p], nid), wd.count, w);
                               touched.insert(pkey(wd.units[p], nid)); }
                if (n != -1) { tr.add_pair(pkey(nid, wd.units[n]), wd.count, w);
                               touched.insert(pkey(nid, wd.units[n])); }
            }
        }
        tr.pair_count.erase(best);
        for (int32_t u : {a, b}) {          // counts of a/b changed: rescore
            auto it = tr.unit_pairs.find(u);
            if (it != tr.unit_pairs.end())
                for (uint64_t p : it->second) touched.insert(p);
        }
        for (uint64_t p : touched) tr.push_heap(p);
        ++m;
    }

    // emit unit table
    i64 n_units = i64(tr.units.size());
    if (n_units > out_cap) return -1;
    i64 pos = 0;
    out_offs[0] = 0;
    for (i64 uidx = 0; uidx < n_units; ++uidx) {
        const Unit& un = tr.units[uidx];
        if (pos + i64(un.syms.size()) > out_syms_cap) return -1;
        std::memcpy(out_syms + pos, un.syms.data(), un.syms.size() * sizeof(int32_t));
        pos += i64(un.syms.size());
        out_offs[uidx + 1] = pos;
        out_cont[uidx] = un.cont ? 1 : 0;
    }
    return n_units;
}

// ---------------------------------------------------------------- encoding

namespace {
struct TrieNode {
    std::unordered_map<int32_t, int32_t> kids;
    int32_t unit = -1;            // unit id terminating here
};
struct Encoder {
    std::vector<TrieNode> init_trie{1}, cont_trie{1};

    void insert(std::vector<TrieNode>& t, const int32_t* s, i64 len, int32_t uid) {
        int32_t cur = 0;
        for (i64 i = 0; i < len; ++i) {
            auto it = t[cur].kids.find(s[i]);
            if (it == t[cur].kids.end()) {
                t[cur].kids[s[i]] = int32_t(t.size());
                cur = int32_t(t.size());
                t.push_back({});
            } else cur = it->second;
        }
        t[cur].unit = uid;
    }

    int32_t longest(const std::vector<TrieNode>& t, const int32_t* s, i64 len,
                    i64* matched) const {
        int32_t cur = 0, best = -1;
        i64 best_len = 0;
        for (i64 i = 0; i < len; ++i) {
            auto it = t[cur].kids.find(s[i]);
            if (it == t[cur].kids.end()) break;
            cur = it->second;
            if (t[cur].unit >= 0) { best = t[cur].unit; best_len = i + 1; }
        }
        *matched = best_len;
        return best;
    }
};
}  // namespace

void* wp_encoder_new(const int32_t* unit_syms, const i64* unit_offs,
                     const int8_t* unit_cont, i64 n_units) {
    Encoder* e = new Encoder();
    for (i64 u = 0; u < n_units; ++u) {
        const int32_t* s = unit_syms + unit_offs[u];
        i64 len = unit_offs[u + 1] - unit_offs[u];
        e->insert(unit_cont[u] ? e->cont_trie : e->init_trie, s, len, int32_t(u));
    }
    return e;
}

void wp_encoder_free(void* h) { delete static_cast<Encoder*>(h); }

// Encode one word (symbol sequence) to unit ids, greedy longest-match.
// Returns number of units written, or -1 if out_cap too small / no match
// (cannot happen when the full alphabet is in the vocab).
i64 wp_encode(void* h, const int32_t* syms, i64 len, int32_t* out, i64 out_cap) {
    Encoder* e = static_cast<Encoder*>(h);
    i64 pos = 0, n_out = 0;
    bool first = true;
    while (pos < len) {
        i64 matched = 0;
        int32_t uid = e->longest(first ? e->init_trie : e->cont_trie,
                                 syms + pos, len - pos, &matched);
        if (uid < 0 || matched == 0) return -1;
        if (n_out >= out_cap) return -1;
        out[n_out++] = uid;
        pos += matched;
        first = false;
    }
    return n_out;
}

}  // extern "C"
