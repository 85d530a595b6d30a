"""Copy of `musicnlp_tpu/io/midi.py` (pure Python / numpy): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_pipeline.py).

First-party Standard MIDI File reader/writer (no mido/pretty_midi/music21).

Reader: SMF 0/1 -> bar-structured `Score` (notes sliced at bar boundaries from the
time-signature map, simultaneous equal-length notes merged into Chords, drums
flagged by channel 10).  This replaces the reference's external
MuseScore/LogicPro MIDI->MXL conversion step + music21 parse
(reference musicnlp/preprocess/music_extractor.py:1009, batch-processing/).

Writer: `Score` -> canonical deterministic format-1 SMF: PPQ=480, conductor track
with tempo/time-sig, one track per part, notes sorted by (offset, pitch),
velocity preserved.  Canonical serialization is pinned so decoded output is
byte-reproducible (BASELINE.md north star).
"""
from __future__ import annotations

import struct
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from musicnlp_tpu_torch.io.score import (
    Chord, Measure, Note, Part, Pitch, Rest, Score, time_sig2bar_dur,
)

__all__ = ['read_midi', 'write_midi', 'PPQ']

PPQ = 480  # ticks per quarter note; 1/32-note slot (precision 5) = 60 ticks exactly


# ---------------------------------------------------------------------------- write
def _vlq(n: int) -> bytes:
    """Variable-length quantity encoding."""
    out = [n & 0x7F]
    n >>= 7
    while n:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    return bytes(reversed(out))


def _track_chunk(events: List[Tuple[int, bytes]]) -> bytes:
    """events: list of (abs_tick, event_bytes) -> MTrk chunk with delta times."""
    events = sorted(events, key=lambda e: e[0])
    data = bytearray()
    last = 0
    for tick, ev in events:
        data += _vlq(tick - last) + ev
        last = tick
    data += _vlq(0) + b'\xff\x2f\x00'  # end of track
    return b'MTrk' + struct.pack('>I', len(data)) + bytes(data)


def write_midi(score: Score, path: str):
    tracks: List[bytes] = []

    # conductor track: title, tempo & time-sig changes (taken from the first part's measures)
    cond: List[Tuple[int, bytes]] = []
    title = (score.title or 'untitled').encode('utf-8')
    cond.append((0, b'\xff\x03' + _vlq(len(title)) + title))
    ref_part = score.parts[0] if score.parts else Part()
    seen_any_tempo = seen_any_ts = False
    for m in ref_part.measures:
        tick = int(m.offset * PPQ)
        if m.time_sig is not None:
            n, d = m.time_sig
            dd = d.bit_length() - 1  # denominator as power of 2
            cond.append((tick, b'\xff\x58\x04' + bytes([n, dd, 24, 8])))
            seen_any_ts = True
        if m.tempo is not None:
            usec = round(60_000_000 / m.tempo)
            cond.append((tick, b'\xff\x51\x03' + usec.to_bytes(3, 'big')))
            seen_any_tempo = True
    if not seen_any_ts:
        cond.append((0, b'\xff\x58\x04' + bytes([4, 2, 24, 8])))
    if not seen_any_tempo:
        cond.append((0, b'\xff\x51\x03' + (500000).to_bytes(3, 'big')))
    tracks.append(_track_chunk(cond))

    for pi, part in enumerate(score.parts):
        ch = 9 if part.is_drum else part.midi_channel or (pi if pi < 9 else pi + 1)
        evs: List[Tuple[int, bytes]] = []
        name = (part.name or f'Part {pi + 1}').encode('utf-8')
        evs.append((0, b'\xff\x03' + _vlq(len(name)) + name))
        evs.append((0, bytes([0xC0 | ch, part.midi_program])))
        # pass 1: collect per-pitch segments in emission order
        # seg = [on_tick, off_tick, midi, vel, tie, skip]
        segs: List[list] = []
        for m in part.measures:
            base = m.offset
            streams = [m.elements] if not m.voices else m.voices
            for elems in streams:
                for e in elems:
                    if isinstance(e, Rest):
                        continue
                    on = int((base + e.offset) * PPQ)
                    off = int((base + e.end) * PPQ)
                    if off <= on:
                        continue
                    pitches = e.pitches if isinstance(e, Chord) else [e.pitch]
                    vel = getattr(e, 'velocity', 90) or 90
                    tie = getattr(e, 'tie', None)
                    for p in sorted(pitches, key=lambda p: p.midi):
                        segs.append([on, off, p.midi, vel, tie, False])
        # pass 2: merge tie chains -- a start/continue segment absorbs the
        # same-pitch segment that begins exactly at its end and is marked
        # stop/continue, extending the head's note-off through the chain.
        # Orphan continuations (no preceding start) still sound on their own
        # rather than being dropped.
        by_pitch: Dict[int, List[list]] = {}
        for s in segs:
            by_pitch.setdefault(s[2], []).append(s)
        for chain in by_pitch.values():
            chain.sort(key=lambda s: s[0])
            i = 0
            while i < len(chain):
                head = chain[i]
                j = i + 1
                while (head[4] in ('start', 'continue') and j < len(chain)
                       and chain[j][0] == head[1]
                       and chain[j][4] in ('stop', 'continue')):
                    head[1] = chain[j][1]       # extend note-off
                    head[4] = chain[j][4]       # chain continues past a 'continue'
                    chain[j][5] = True          # absorbed: do not emit
                    j += 1
                i = j
        for on, off, midi, vel, _, skip in segs:
            if skip:
                continue
            evs.append((on, bytes([0x90 | ch, midi, vel])))
            evs.append((off, bytes([0x80 | ch, midi, 0])))
        tracks.append(_track_chunk(evs))

    with open(path, 'wb') as f:
        f.write(b'MThd' + struct.pack('>IHHH', 6, 1, len(tracks), PPQ))
        for t in tracks:
            f.write(t)


# ---------------------------------------------------------------------------- read
class _RawNote:
    __slots__ = ('pitch', 'start', 'end', 'velocity', 'channel')

    def __init__(self, pitch, start, end, velocity, channel):
        self.pitch, self.start, self.end = pitch, start, end
        self.velocity, self.channel = velocity, channel


def _read_vlq(data: bytes, i: int) -> Tuple[int, int]:
    v = 0
    while True:
        b = data[i]
        i += 1
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            return v, i


def _parse_track(data: bytes):
    """Yield (abs_tick, status, payload) for one MTrk chunk body."""
    i, tick, status = 0, 0, 0
    while i < len(data):
        delta, i = _read_vlq(data, i)
        tick += delta
        b = data[i]
        if b & 0x80:
            status = b
            i += 1
        if status == 0xFF:  # meta
            meta_type = data[i]
            ln, i2 = _read_vlq(data, i + 1)
            payload = data[i2:i2 + ln]
            i = i2 + ln
            yield tick, 0xFF, bytes([meta_type]) + payload
        elif status in (0xF0, 0xF7):  # sysex
            ln, i2 = _read_vlq(data, i)
            i = i2 + ln
        else:
            kind = status & 0xF0
            n_data = 1 if kind in (0xC0, 0xD0) else 2
            payload = data[i:i + n_data]
            i += n_data
            yield tick, status, payload


def read_midi(path: str, merge_chords: bool = True) -> Score:
    """Parse an SMF into a bar-structured Score.

    Bars are derived from the time-signature event map (default 4/4); notes are
    clipped into bars with ties; per-bar tempo/time-sig changes are attached to
    the measure where they occur.
    """
    with open(path, 'rb') as f:
        data = f.read()
    assert data[:4] == b'MThd', 'not a MIDI file'
    hdr_len, fmt, n_trk, division = struct.unpack('>IHHH', data[4:14])
    assert division & 0x8000 == 0, 'SMPTE time division not supported'
    ppq = division

    i = 8 + hdr_len
    tracks_raw: List[List[Tuple[int, int, bytes]]] = []
    while i < len(data) and len(tracks_raw) < n_trk:
        assert data[i:i + 4] == b'MTrk', f'bad chunk at {i}'
        ln = struct.unpack('>I', data[i + 4:i + 8])[0]
        tracks_raw.append(list(_parse_track(data[i + 8:i + 8 + ln])))
        i += 8 + ln

    # global meta maps
    tempo_events: List[Tuple[int, float]] = []   # (tick, bpm)
    ts_events: List[Tuple[int, Tuple[int, int]]] = []  # (tick, (n, d))
    title = ''
    for trk in tracks_raw:
        for tick, status, payload in trk:
            if status == 0xFF:
                mt = payload[0]
                if mt == 0x51 and len(payload) >= 4:
                    usec = int.from_bytes(payload[1:4], 'big')
                    if usec > 0:
                        # snap to 2 decimals: undoes the usec-per-beat rounding so
                        # integer BPMs written by `write_midi` read back exactly
                        tempo_events.append((tick, round(60_000_000 / usec, 2)))
                elif mt == 0x58 and len(payload) >= 3:
                    ts_events.append((tick, (payload[1], 1 << payload[2])))
                elif mt == 0x03 and not title:
                    title = payload[1:].decode('utf-8', errors='replace')
    tempo_events.sort()
    ts_events.sort()
    if not ts_events or ts_events[0][0] > 0:
        ts_events.insert(0, (0, (4, 4)))
    if not tempo_events or tempo_events[0][0] > 0:
        tempo_events.insert(0, (0, 120.0))

    # per-track note extraction
    parts_notes: List[Tuple[str, int, int, List[_RawNote]]] = []  # (name, program, channel, notes)
    max_tick = 0
    for trk in tracks_raw:
        active: Dict[Tuple[int, int], Tuple[int, int]] = {}  # (ch, pitch) -> (start, vel)
        notes: List[_RawNote] = []
        name, program = '', 0
        for tick, status, payload in trk:
            max_tick = max(max_tick, tick)
            if status == 0xFF:
                if payload[0] == 0x03 and not name:
                    name = payload[1:].decode('utf-8', errors='replace')
                continue
            kind, ch = status & 0xF0, status & 0x0F
            if kind == 0xC0:
                program = payload[0]
            elif kind == 0x90 and payload[1] > 0:
                key = (ch, payload[0])
                if key in active:  # retrigger: close previous
                    st, vel = active.pop(key)
                    if tick > st:
                        notes.append(_RawNote(payload[0], st, tick, vel, ch))
                active[key] = (tick, payload[1])
            elif kind == 0x80 or (kind == 0x90 and payload[1] == 0):
                key = (ch, payload[0])
                if key in active:
                    st, vel = active.pop(key)
                    if tick > st:
                        notes.append(_RawNote(payload[0], st, tick, vel, ch))
        for (ch, pitch), (st, vel) in active.items():  # unterminated notes
            if max_tick > st:
                notes.append(_RawNote(pitch, st, max_tick, vel, ch))
        if notes:
            # a single track can interleave several channels (format-0 SMFs
            # put the whole song in one track): split per channel so drums
            # (channel 10) don't flag melodic channels as percussion
            by_ch: Dict[int, List[_RawNote]] = {}
            for n in notes:
                by_ch.setdefault(n.channel, []).append(n)
            for ch in sorted(by_ch):
                ch_notes = by_ch[ch]
                ch_notes.sort(key=lambda n: (n.start, n.pitch))
                nm = name if len(by_ch) == 1 else (f'{name} ch{ch + 1}' if name
                                                   else f'ch{ch + 1}')
                parts_notes.append((nm, program, ch, ch_notes))

    # bar grid from time-sig map
    end_ql = Fraction(max_tick, ppq)
    bars: List[Tuple[Fraction, Fraction, Optional[Tuple[int, int]]]] = []  # (start, dur, ts-if-new)
    pos = Fraction(0)
    for k, (tick, ts) in enumerate(ts_events):
        seg_start = Fraction(tick, ppq)
        seg_end = Fraction(ts_events[k + 1][0], ppq) if k + 1 < len(ts_events) else end_ql
        if seg_end <= seg_start and k + 1 < len(ts_events):
            continue
        bar_dur = time_sig2bar_dur(ts)
        pos = seg_start
        first = True
        while pos < seg_end or (first and pos == seg_start == seg_end == end_ql):
            bars.append((pos, bar_dur, ts if first else None))
            pos += bar_dur
            first = False
    if not bars:
        bars = [(Fraction(0), Fraction(4), (4, 4))]

    # tempo per bar (attach where a tempo event falls)
    tempo_by_bar: Dict[int, float] = {}
    for tick, bpm in tempo_events:
        ql = Fraction(tick, ppq)
        for bi, (bstart, bdur, _) in enumerate(bars):
            if bstart <= ql < bstart + bdur:
                tempo_by_bar.setdefault(bi, bpm)
                break
        else:
            if ql >= bars[-1][0]:
                tempo_by_bar.setdefault(len(bars) - 1, bpm)

    score = Score(title=title, source='midi')
    for name, program, ch, notes in parts_notes:
        part = Part(name=name, is_drum=(ch == 9), midi_program=program, midi_channel=ch)
        # slice notes into bars with ties
        measures = []
        for bi, (bstart, bdur, ts) in enumerate(bars):
            m = Measure(number=bi, offset=bstart, time_sig=ts, tempo=tempo_by_bar.get(bi))
            measures.append(m)
        for rn in notes:
            st, en = Fraction(rn.start, ppq), Fraction(rn.end, ppq)
            for bi, (bstart, bdur, _) in enumerate(bars):
                bend = bstart + bdur
                if en <= bstart or st >= bend:
                    continue
                seg_start, seg_end = max(st, bstart), min(en, bend)
                tie = None
                if st < bstart and en > bend:
                    tie = 'continue'
                elif st < bstart:
                    tie = 'stop'
                elif en > bend:
                    tie = 'start'
                measures[bi].elements.append(Note(
                    pitch=Pitch(midi=rn.pitch), duration=seg_end - seg_start,
                    offset=seg_start - bstart, velocity=rn.velocity, tie=tie,
                ))
        for m in measures:
            m.elements.sort(key=lambda n: (n.offset, n.pitch.midi))
            if merge_chords:
                m.elements = _merge_chords(m.elements)
        part.measures = measures
        score.parts.append(part)
    return score


def _merge_chords(elems: List[Note]) -> List:
    """Merge simultaneous equal-duration notes into Chord objects."""
    out: List = []
    i = 0
    while i < len(elems):
        n = elems[i]
        j = i + 1
        group = [n]
        while (j < len(elems) and isinstance(elems[j], Note) and isinstance(n, Note)
               and elems[j].offset == n.offset and elems[j].dur == n.dur):
            group.append(elems[j])
            j += 1
        if len(group) > 1:
            out.append(Chord(pitches=[g.pitch for g in group], duration=n.dur,
                             offset=n.offset, velocity=max(g.velocity for g in group),
                             tm=getattr(n, 'tm', None)))
        else:
            out.append(n)
        i = j
    return out
