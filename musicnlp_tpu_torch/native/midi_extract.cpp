// Copy of musicnlp_tpu/native/midi_extract.cpp: the port builds its own copy
// (musicnlp_tpu_torch/native/__init__.py) and never loads the JAX package's library.
//
// Fast MIDI -> music-token extraction kernel.
//
// Native counterpart of the Python extractor's hot path
// (musicnlp_tpu_torch/preprocess/music_extractor.py; the reference's stated
// bottleneck is music21 per-note object churn, reference
// musicnlp/preprocess/music_extractor.py:182).  Scope: Standard MIDI File
// (format 0/1) parsing, per-bar time-signature/tempo carry, skyline
// melody/bass selection, and slot quantization -- producing (pitch, n_slots)
// run pairs per bar that the Python wrapper renders to vocabulary tokens.
//
// Semantics mirror the Python pipeline on MIDI-sourced corpora:
//   * skyline = "at every instant sound the highest-pitched active note"
//     (the Python get_notes_out truncation/makeup recursion computes exactly
//     this on the slot grid); bass = lowest active note, rest when it would
//     duplicate the melody;
//   * quantization = per-slot majority overlap, run-length compressed;
//   * bar list cropped of leading/trailing empty bars; drum channel (ch 9)
//     excluded; mode time-sig, mean rounded tempo.
//
// C ABI (ctypes).  Output protocol: int32 stream
//   [n_bar, ts_num, ts_den, tempo,
//    per bar: n_mel, n_bass, (pitch, n_slots)*n_mel, (pitch, n_slots)*n_bass]
// pitch -1 = rest.  Returns stream length, or -1 parse error, -2 no notes,
// -3 output buffer too small.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC midi_extract.cpp -o libmidiextract.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

using i64 = long long;

struct NoteEv {
    i64 on, off;      // ticks
    int pitch;
};

struct MetaEv {
    i64 tick;
    int a, b;         // tempo bpm*1000 in a, or timesig (a, b)
};

struct Parser {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    uint8_t u8() {
        if (p >= end) { ok = false; return 0; }
        return *p++;
    }
    uint32_t u32() {
        uint32_t v = 0;
        for (int i = 0; i < 4; ++i) v = (v << 8) | u8();
        return v;
    }
    uint16_t u16() {
        uint16_t v = 0;
        for (int i = 0; i < 2; ++i) v = uint16_t((v << 8) | u8());
        return v;
    }
    i64 vlq() {
        i64 v = 0;
        for (int i = 0; i < 8; ++i) {
            uint8_t b = u8();
            v = (v << 7) | (b & 0x7f);
            if (!(b & 0x80)) break;
        }
        return v;
    }
    void skip(i64 n) {
        if (p + n > end) { ok = false; p = end; } else p += n;
    }
};

bool parse_smf(const uint8_t* data, i64 len, i64* division,
               std::vector<NoteEv>& notes, std::vector<MetaEv>& tempos,
               std::vector<MetaEv>& timesigs) {
    Parser hp{data, data + len};
    if (len < 14 || std::memcmp(data, "MThd", 4) != 0) return false;
    hp.p += 4;
    uint32_t hlen = hp.u32();
    uint16_t fmt = hp.u16();
    uint16_t ntrk = hp.u16();
    uint16_t div = hp.u16();
    if (div & 0x8000) return false;         // SMPTE timing unsupported
    *division = div ? div : 480;
    hp.skip(i64(hlen) - 6);
    (void)fmt;

    for (int t = 0; t < ntrk && hp.ok; ++t) {
        if (hp.p + 8 > hp.end || std::memcmp(hp.p, "MTrk", 4) != 0) return false;
        hp.p += 4;
        uint32_t tlen = hp.u32();
        Parser tp{hp.p, hp.p + tlen};
        if (tp.end > hp.end) return false;
        hp.skip(tlen);

        i64 tick = 0;
        uint8_t running = 0;
        // per (channel, pitch) stack of note-on ticks
        std::map<int, std::vector<i64>> open;
        while (tp.ok && tp.p < tp.end) {
            tick += tp.vlq();
            uint8_t st = tp.u8();
            if (st < 0x80) { --tp.p; st = running; }
            else if (st < 0xf0) running = st;
            if (st == 0xff) {                       // meta
                uint8_t type = tp.u8();
                i64 mlen = tp.vlq();
                const uint8_t* mp = tp.p;
                tp.skip(mlen);
                if (type == 0x51 && mlen == 3) {
                    i64 uspq = (i64(mp[0]) << 16) | (i64(mp[1]) << 8) | mp[2];
                    if (uspq > 0)
                        tempos.push_back({tick, int(60000000000LL / uspq), 0});
                } else if (type == 0x58 && mlen >= 2) {
                    timesigs.push_back({tick, int(mp[0]), 1 << mp[1]});
                }
            } else if (st == 0xf0 || st == 0xf7) {  // sysex
                tp.skip(tp.vlq());
            } else {
                int kind = st >> 4, ch = st & 0xf;
                int d1 = tp.u8();
                int d2 = (kind == 0xc || kind == 0xd) ? 0 : tp.u8();
                if (ch == 9) continue;              // drum channel
                int key = ch * 128 + d1;
                if (kind == 0x9 && d2 > 0) {
                    open[key].push_back(tick);
                } else if (kind == 0x8 || (kind == 0x9 && d2 == 0)) {
                    auto it = open.find(key);
                    if (it != open.end() && !it->second.empty()) {
                        i64 on = it->second.back();
                        it->second.pop_back();
                        if (tick > on) notes.push_back({on, tick, d1});
                    }
                }
            }
        }
    }
    std::sort(tempos.begin(), tempos.end(),
              [](const MetaEv& a, const MetaEv& b) { return a.tick < b.tick; });
    std::sort(timesigs.begin(), timesigs.end(),
              [](const MetaEv& a, const MetaEv& b) { return a.tick < b.tick; });
    std::sort(notes.begin(), notes.end(),
              [](const NoteEv& a, const NoteEv& b) { return a.on < b.on; });
    return true;
}

// A note snapped to the bar's slot grid.
struct SNote {
    int on, end, pitch;   // [on, end) in slots
    bool alive = true;
};

// Skyline sweep, mirroring the Python extractor's get_notes_out exactly
// (music_extractor.py:401-461) on integer slots:
//   * iterate onset groups ascending, taking the extreme-pitch note;
//   * a strictly-better later note TRUNCATES the current one (its tail is
//     discarded, it never resumes);
//   * a worse later note that OUTLASTS the current is truncated at the front
//     and re-inserted at the current note's end (makeup), restarting the
//     sweep;
//   * otherwise the later note is fully covered and skipped.
std::vector<SNote> skyline(std::vector<SNote> pool, bool keep_high) {
    auto better = [&](int a, int b) {   // pitch a strictly better than b
        return keep_high ? a > b : a < b;
    };
    for (bool restart = true; restart;) {
        restart = false;
        // onset -> pool indices, insertion-ordered
        std::map<int, std::vector<int>> groups;
        for (int i = 0; i < int(pool.size()); ++i)
            if (pool[i].alive && pool[i].end > pool[i].on)
                groups[pool[i].on].push_back(i);
        std::vector<int> out;
        int last_end = -1;
        for (auto& [onset, idxs] : groups) {
            // extreme pitch; ties -> latest inserted (python stable sort + [-1])
            int pick = idxs[0];
            for (int i : idxs)
                if (better(pool[i].pitch, pool[pick].pitch)
                    || pool[i].pitch == pool[pick].pitch) pick = i;
            SNote& nt = pool[pick];
            if (last_end > onset && !out.empty()) {
                SNote& last = pool[out.back()];
                if (better(nt.pitch, last.pitch)) {        // truncate last
                    last.end = onset;
                    if (last.end <= last.on) {             // was a makeup: drop
                        last.alive = false;
                        out.pop_back();
                    }
                    out.push_back(pick);
                    last_end = nt.end;
                } else if (nt.end > last_end) {            // makeup: re-insert tail
                    nt.on = last_end;
                    restart = true;
                    break;
                }
                // else: fully covered -> skipped (stays in groups, same as
                // the python sweep)
            } else {
                out.push_back(pick);
                last_end = nt.end;
            }
        }
        if (!restart) {
            std::vector<SNote> res;
            for (int i : out) res.push_back(pool[i]);
            return res;
        }
    }
    return {};
}

}  // namespace

extern "C" {

i64 me_extract(const uint8_t* data, i64 len, i64 precision, i64 full_mode,
               int32_t* out, i64 out_cap) {
    i64 division;
    std::vector<NoteEv> notes;
    std::vector<MetaEv> tempos, timesigs;
    if (!parse_smf(data, len, &division, notes, tempos, timesigs)) return -1;
    if (notes.empty()) return -2;

    // slot size in ticks: slot = 4/2^prec quarterLength
    // ticks per quarter = division; slot_ticks may be fractional for tiny
    // divisions -- work in double, quantize by rounding
    double slot_q = 4.0 / double(1LL << precision);    // quarterLengths
    double tpq = double(division);

    // bar construction: walk time-sig changes; bar boundaries in ticks
    i64 last_tick = 0;
    for (auto& n : notes) last_tick = std::max(last_tick, n.off);

    struct Bar { i64 start, end; int num, den, tempo; };
    std::vector<Bar> bars;
    {
        size_t tsi = 0, tpi = 0;
        int num = 4, den = 4, bpm = 120 * 1000;
        // default tempo from first tempo event at tick 0 if any
        i64 tick = 0;
        while (tick < last_tick) {
            while (tsi < timesigs.size() && timesigs[tsi].tick <= tick) {
                num = timesigs[tsi].a;
                den = timesigs[tsi].b ? timesigs[tsi].b : 4;
                ++tsi;
            }
            while (tpi < tempos.size() && tempos[tpi].tick <= tick) {
                bpm = tempos[tpi].a;
                ++tpi;
            }
            double bar_q = 4.0 * num / den;
            i64 bar_ticks = i64(std::llround(bar_q * tpq));
            if (bar_ticks <= 0) return -1;
            bars.push_back({tick, tick + bar_ticks, num, den,
                            int(std::llround(bpm / 1000.0))});
            tick += bar_ticks;
        }
    }
    if (bars.empty()) return -2;

    // per-bar note pools on the slot grid (note identity preserved)
    int n_bar_total = int(bars.size());
    std::vector<std::vector<SNote>> pools(n_bar_total);
    std::vector<int> bar_slots(n_bar_total);
    std::vector<bool> has_note(n_bar_total, false);
    for (int b = 0; b < n_bar_total; ++b) {
        double bar_q = 4.0 * bars[b].num / bars[b].den;
        bar_slots[b] = int(std::ceil(bar_q / slot_q - 1e-9));
    }
    double s_ticks = slot_q * tpq;
    for (const auto& n : notes) {
        for (int b = 0; b < n_bar_total; ++b) {
            if (n.off <= bars[b].start || n.on >= bars[b].end) continue;
            i64 lo_t = std::max(n.on, bars[b].start) - bars[b].start;
            i64 hi_t = std::min(n.off, bars[b].end) - bars[b].start;
            // majority-overlap slot snap
            int s0 = int(std::floor(lo_t / s_ticks + 0.5));
            int s1 = int(std::floor(hi_t / s_ticks + 0.5));
            if (s1 <= s0) {                    // sub-slot note: round to one slot
                s0 = std::min(s0, bar_slots[b] - 1);
                s1 = s0 + 1;
            }
            s0 = std::max(0, std::min(s0, bar_slots[b]));
            s1 = std::max(0, std::min(s1, bar_slots[b]));
            if (s1 > s0) {
                pools[b].push_back({s0, s1, n.pitch, true});
                has_note[b] = true;
            }
        }
    }

    // crop empty bars at both ends (reference music_extractor.py:1026-1039)
    int first = 0, last = n_bar_total - 1;
    while (first < n_bar_total && !has_note[first]) ++first;
    if (first == n_bar_total) return -2;
    while (!has_note[last]) --last;

    // mode time-sig + mean tempo over kept bars
    std::map<std::pair<int, int>, int> ts_count;
    double tempo_sum = 0;
    for (int b = first; b <= last; ++b) {
        ts_count[{bars[b].num, bars[b].den}] += 1;
        tempo_sum += bars[b].tempo;
    }
    auto ts_mode = std::max_element(
        ts_count.begin(), ts_count.end(),
        [](auto& a, auto& b) { return a.second < b.second; })->first;
    int tempo_mean = int(std::llround(tempo_sum / (last - first + 1)));

    // emit
    i64 pos = 0;
    auto put = [&](i64 v) -> bool {
        if (pos >= out_cap) return false;
        out[pos++] = int32_t(v);
        return true;
    };
    if (!put(last - first + 1) || !put(ts_mode.first) || !put(ts_mode.second)
        || !put(tempo_mean)) return -3;
    // fill gaps with rests + emit (pitch, n_slots) runs; consecutive rests
    // merge (join_consecutive_rest_notes semantics)
    auto emit_runs = [&](const std::vector<SNote>& ns, int n_slots,
                         std::vector<std::pair<int, int>>& runs) {
        runs.clear();
        int cur = 0;
        auto put_rest = [&](int upto) {
            if (upto > cur) {
                if (!runs.empty() && runs.back().first == -1)
                    runs.back().second += upto - cur;
                else
                    runs.push_back({-1, upto - cur});
                cur = upto;
            }
        };
        for (const auto& n : ns) {
            put_rest(n.on);
            runs.push_back({n.pitch, n.end - n.on});
            cur = n.end;
        }
        put_rest(n_slots);
    };

    std::vector<std::pair<int, int>> runs_m, runs_b;
    for (int b = first; b <= last; ++b) {
        std::vector<SNote> mel = skyline(pools[b], true);
        std::vector<SNote> bas;
        if (full_mode) {
            bas = skyline(pools[b], false);
            // drop bass notes identical to a melody-selected note
            // (music_extractor.py extract_notes full-mode dedup)
            std::vector<SNote> kept;
            for (const auto& nb : bas) {
                bool dup = false;
                for (const auto& nm : mel)
                    if (nb.on == nm.on && nb.end == nm.end
                        && nb.pitch == nm.pitch) { dup = true; break; }
                if (!dup) kept.push_back(nb);
            }
            bas = std::move(kept);
        }
        emit_runs(mel, bar_slots[b], runs_m);
        emit_runs(bas, bar_slots[b], runs_b);
        if (!put(i64(runs_m.size())) || !put(i64(runs_b.size()))) return -3;
        for (auto& r : runs_m)
            if (!put(r.first) || !put(r.second)) return -3;
        for (auto& r : runs_b)
            if (!put(r.first) || !put(r.second)) return -3;
    }
    return pos;
}

}  // extern "C"
