"""Copy of `musicnlp_tpu/io/musicxml.py` (pure Python / numpy): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_pipeline.py).

First-party MusicXML / MXL reader & writer (stdlib xml.etree + zipfile only).

Replaces music21's MXL surface used by the reference for (a) writing rendered
scores (reference musicnlp/trainer/eval.py:369-383, music_converter.py:428) and
(b) reading MuseScore-converted corpus files & extracted-song prompts
(music_extractor.py:1009, music_converter.py:162).

Emission is canonical & deterministic: fixed divisions=10080 (divisible by
2^5, 3, 5, 7, 9 -> precision-5 slots and all tuplet subdivisions are integral).
"""
from __future__ import annotations

import io
import zipfile
from fractions import Fraction
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree as ET

from musicnlp_tpu_torch.io.score import (
    Chord, Measure, Note, Part, Pitch, Rest, Score,
)

__all__ = ['write_musicxml', 'write_mxl', 'read_musicxml', 'read_mxl', 'parse_file', 'DIVISIONS']

DIVISIONS = 10080  # per quarter note


# ---------------------------------------------------------------------------- write
def _dur_ticks(ql: Fraction) -> int:
    t = ql * DIVISIONS
    assert t.denominator == 1, f'duration {ql} not representable at divisions={DIVISIONS}'
    return int(t)


_QL2TYPE = {
    Fraction(4): 'whole', Fraction(2): 'half', Fraction(1): 'quarter',
    Fraction(1, 2): 'eighth', Fraction(1, 4): '16th', Fraction(1, 8): '32nd',
    Fraction(1, 16): '64th',
}


def _note_xml(parent: ET.Element, e, chord_pitch: Optional[Pitch] = None, is_chord_follow=False):
    n = ET.SubElement(parent, 'note')
    if is_chord_follow:
        ET.SubElement(n, 'chord')
    if isinstance(e, Rest) and chord_pitch is None:
        ET.SubElement(n, 'rest')
    else:
        p = chord_pitch if chord_pitch is not None else e.pitch
        pe = ET.SubElement(n, 'pitch')
        ET.SubElement(pe, 'step').text = p.step
        if p.alter:
            ET.SubElement(pe, 'alter').text = str(p.alter)
        ET.SubElement(pe, 'octave').text = str(p.octave)
    ET.SubElement(n, 'duration').text = str(_dur_ticks(e.dur))
    tie = getattr(e, 'tie', None)
    if tie in ('start', 'continue'):
        ET.SubElement(n, 'tie', type='start')
    if tie in ('stop', 'continue'):
        ET.SubElement(n, 'tie', type='stop')
    ET.SubElement(n, 'voice').text = '1'
    base = _QL2TYPE.get(Fraction(e.dur))
    if base:
        ET.SubElement(n, 'type').text = base
    else:
        # tuplet-fraction duration: emit time-modification so standard readers cope
        f = Fraction(e.dur)
        den_odd = f.denominator
        while den_odd % 2 == 0:
            den_odd //= 2
        if den_odd > 1:
            tm = ET.SubElement(n, 'time-modification')
            ET.SubElement(tm, 'actual-notes').text = str(den_odd)
            # conventional ratio: n-plet in the time of the next-lower power of 2
            ET.SubElement(tm, 'normal-notes').text = str(2 ** (den_odd.bit_length() - 1))
    return n


def score2xml(score: Score) -> ET.Element:
    root = ET.Element('score-partwise', version='3.1')
    work = ET.SubElement(root, 'work')
    ET.SubElement(work, 'work-title').text = score.title or 'untitled'
    ident = ET.SubElement(root, 'identification')
    creator = ET.SubElement(ident, 'creator', type='composer')
    creator.text = score.composer

    part_list = ET.SubElement(root, 'part-list')
    for i, part in enumerate(score.parts, start=1):
        sp = ET.SubElement(part_list, 'score-part', id=f'P{i}')
        ET.SubElement(sp, 'part-name').text = part.name or f'Part {i}'

    for i, part in enumerate(score.parts, start=1):
        pe = ET.SubElement(root, 'part', id=f'P{i}')
        for mi, m in enumerate(part.measures):
            me = ET.SubElement(pe, 'measure', number=str(m.number if m.number is not None else mi))
            if mi == 0 or m.time_sig is not None:
                attrs = ET.SubElement(me, 'attributes')
                ET.SubElement(attrs, 'divisions').text = str(DIVISIONS)
                if m.time_sig is not None:
                    t = ET.SubElement(attrs, 'time')
                    ET.SubElement(t, 'beats').text = str(m.time_sig[0])
                    ET.SubElement(t, 'beat-type').text = str(m.time_sig[1])
                if mi == 0:
                    clef = ET.SubElement(attrs, 'clef')
                    ET.SubElement(clef, 'sign').text = 'F' if m.is_bass_clef else 'G'
                    ET.SubElement(clef, 'line').text = '4' if m.is_bass_clef else '2'
            if m.tempo is not None:
                d = ET.SubElement(me, 'direction', placement='above')
                dt = ET.SubElement(d, 'direction-type')
                met = ET.SubElement(dt, 'metronome')
                ET.SubElement(met, 'beat-unit').text = 'quarter'
                per_min = m.tempo
                ET.SubElement(met, 'per-minute').text = (
                    str(int(per_min)) if float(per_min).is_integer() else str(per_min))
                ET.SubElement(d, 'sound', tempo=str(int(per_min)) if float(per_min).is_integer() else str(per_min))
            # cursor semantics: simultaneous/overlapping notes need explicit
            # <backup>/<forward> moves or readers accumulate wrong offsets
            cursor = Fraction(0)
            for e in m.elements:
                off = Fraction(e.offset)
                if off != cursor:
                    tag = 'backup' if off < cursor else 'forward'
                    mv = ET.SubElement(me, tag)
                    ET.SubElement(mv, 'duration').text = str(
                        abs(int((off - cursor) * DIVISIONS)))
                    cursor = off
                if isinstance(e, Chord):
                    for k, p in enumerate(e.pitches):
                        _note_xml(me, e, chord_pitch=p, is_chord_follow=k > 0)
                else:
                    _note_xml(me, e)
                cursor = off + Fraction(e.dur)
    return root


def write_musicxml(score: Score, path: str):
    root = score2xml(score)
    ET.indent(root)
    tree = ET.ElementTree(root)
    with open(path, 'wb') as f:
        f.write(b'<?xml version="1.0" encoding="UTF-8"?>\n'
                b'<!DOCTYPE score-partwise PUBLIC "-//Recordare//DTD MusicXML 3.1 Partwise//EN" '
                b'"http://www.musicxml.org/dtds/partwise.dtd">\n')
        tree.write(f, encoding='utf-8', xml_declaration=False)


def write_mxl(score: Score, path: str):
    root = score2xml(score)
    ET.indent(root)
    buf = io.BytesIO()
    buf.write(b'<?xml version="1.0" encoding="UTF-8"?>\n')
    ET.ElementTree(root).write(buf, encoding='utf-8', xml_declaration=False)
    inner_name = 'score.xml'
    container = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<container><rootfiles>'
        f'<rootfile full-path="{inner_name}" media-type="application/vnd.recordare.musicxml+xml"/>'
        '</rootfiles></container>'
    )
    with zipfile.ZipFile(path, 'w', zipfile.ZIP_DEFLATED) as z:
        z.writestr('META-INF/container.xml', container)
        z.writestr(inner_name, buf.getvalue())


# ---------------------------------------------------------------------------- read
def _text(el: Optional[ET.Element], default=None):
    return el.text.strip() if el is not None and el.text else default


def read_mxl(path: str) -> Score:
    with zipfile.ZipFile(path) as z:
        inner = None
        try:
            c = ET.fromstring(z.read('META-INF/container.xml'))
            rf = c.find('.//rootfile')
            if rf is not None:
                inner = rf.get('full-path')
        except Exception:
            # real-world MXLs can ship a malformed container.xml (music21
            # writes raw '&' in full-path attributes); fall back to scanning
            pass
        if inner is None or inner not in z.namelist():
            cands = [n for n in z.namelist()
                     if n.endswith(('.xml', '.musicxml')) and not n.startswith('META-INF')]
            assert cands, 'no MusicXML payload in MXL'
            inner = cands[0]
        return read_musicxml_bytes(z.read(inner))


def read_musicxml(path: str) -> Score:
    with open(path, 'rb') as f:
        return read_musicxml_bytes(f.read())


def parse_file(path: str) -> Score:
    """Dispatch on extension: .mxl / .musicxml / .xml / .mid / .midi."""
    low = path.lower()
    if low.endswith('.mxl'):
        return read_mxl(path)
    if low.endswith(('.xml', '.musicxml')):
        return read_musicxml(path)
    if low.endswith(('.mid', '.midi')):
        from musicnlp_tpu_torch.io.midi import read_midi
        return read_midi(path)
    raise ValueError(f'Unknown music file type: {path}')


def read_musicxml_bytes(data: bytes) -> Score:
    root = ET.fromstring(data)
    if root.tag == 'score-timewise':
        raise NotImplementedError('timewise MusicXML not supported')
    assert root.tag == 'score-partwise', f'unexpected root {root.tag}'

    title = _text(root.find('./work/work-title'), '') or _text(root.find('./movement-title'), '')
    composer = ''
    for cr in root.findall('./identification/creator'):
        if cr.get('type') == 'composer':
            composer = _text(cr, '')
    part_names: Dict[str, str] = {}
    part_drum: Dict[str, bool] = {}
    for sp in root.findall('./part-list/score-part'):
        pid = sp.get('id')
        part_names[pid] = _text(sp.find('part-name'), pid)
        # percussion detection: channel 10, or an unpitched-drum instrument
        # name (the reference's instrs_drum classes, music_lib.py:90-97 --
        # music21 resolves MusicXML instrument names to these)
        ch = _text(sp.find('.//midi-instrument/midi-channel'))
        names = ' '.join(filter(None, (
            _text(el) for el in sp.findall('.//instrument-name')))).lower()
        drum_instr = any(k in names for k in (
            'bass drum', 'snare', 'bongo', 'conga', 'tenor drum'))
        part_drum[pid] = (ch == '10') or drum_instr

    score = Score(title=title or '', composer=composer, source='musicxml')
    for pe in root.findall('./part'):
        pid = pe.get('id')
        part = Part(name=part_names.get(pid, pid), is_drum=part_drum.get(pid, False))
        n_pitched = n_unpitched = 0
        divisions = DIVISIONS
        cur_ts: Optional[Tuple[int, int]] = None
        bar_offset = Fraction(0)
        for mi, me in enumerate(pe.findall('measure')):
            m = Measure(number=mi, offset=bar_offset)
            attrs = me.find('attributes')
            if attrs is not None:
                d = _text(attrs.find('divisions'))
                if d:
                    divisions = int(d)
                t = attrs.find('time')
                if t is not None:
                    ts = (int(_text(t.find('beats'))), int(_text(t.find('beat-type'))))
                    m.time_sig = ts
                    cur_ts = ts
                clef = attrs.find('clef')
                if clef is not None and _text(clef.find('sign')) == 'F':
                    m.is_bass_clef = True
            # tempo from <direction><sound tempo> or metronome per-minute;
            # multiple marks in one bar average (reference it_bars
            # music_extractor.py:141-150 takes the per-bar mean of all
            # MetronomeMarks)
            tempi = [float(snd.get('tempo')) for snd in me.iter('sound')
                     if snd.get('tempo')]
            if not tempi:
                tempi = [float(_text(pm)) for pm in me.iter('per-minute')
                         if _text(pm) and _text(pm).replace('.', '', 1).isdigit()]
            if tempi:
                m.tempo = sum(tempi) / len(tempi)

            pos = Fraction(0)
            last_note_start = Fraction(0)
            voices: Dict[str, List] = {}
            for el in me:
                if el.tag == 'backup':
                    pos -= Fraction(int(_text(el.find('duration'))), divisions)
                    # real-world files overshoot backup by a tick or two
                    # (rounding in the producer); a bar can never start < 0
                    if pos < 0:
                        pos = Fraction(0)
                elif el.tag == 'forward':
                    pos += Fraction(int(_text(el.find('duration'))), divisions)
                elif el.tag == 'note':
                    if el.find('grace') is not None:
                        continue  # grace notes carry no duration
                    dur_el = el.find('duration')
                    if dur_el is None:
                        continue
                    ql = Fraction(int(_text(dur_el)), divisions)
                    is_chord = el.find('chord') is not None
                    voice = _text(el.find('voice'), '1')
                    start = last_note_start if is_chord else pos
                    rest = el.find('rest') is not None
                    tie = None
                    ties = {t.get('type') for t in el.findall('tie')}
                    if 'start' in ties and 'stop' in ties:
                        tie = 'continue'
                    elif 'start' in ties:
                        tie = 'start'
                    elif 'stop' in ties:
                        tie = 'stop'
                    tme = el.find('time-modification')
                    tm = None
                    if tme is not None:
                        a, nn = _text(tme.find('actual-notes')), _text(tme.find('normal-notes'))
                        if a and nn:
                            tm = (int(a), int(nn))
                    if rest:
                        obj = Rest(duration=ql, offset=start, tm=tm)
                    else:
                        p = el.find('pitch')
                        if p is None:  # unpitched (percussion)
                            n_unpitched += 1
                            up = el.find('unpitched')
                            step = _text(up.find('display-step'), 'C') if up is not None else 'C'
                            octv = int(_text(up.find('display-octave'), '4')) if up is not None else 4
                            pitch = Pitch.from_name(step, octv)
                        else:
                            n_pitched += 1
                            step = _text(p.find('step'))
                            alter = int(float(_text(p.find('alter'), '0')))
                            octv = int(_text(p.find('octave')))
                            acc = '#' * alter if alter > 0 else '-' * (-alter)
                            pitch = Pitch.from_name(f'{step}{acc}', octv)
                        obj = Note(pitch=pitch, duration=ql, offset=start, tie=tie, tm=tm)
                    voices.setdefault(voice, []).append(obj)
                    if not is_chord:
                        last_note_start = pos
                        pos += ql
            # merge same-offset same-duration notes into chords within each voice
            from musicnlp_tpu_torch.io.midi import _merge_chords
            streams = []
            for vk in sorted(voices):
                vs = sorted(voices[vk], key=lambda n: (n.offset,
                                                       n.pitch.midi if isinstance(n, Note) else -1))
                streams.append(_merge_chords(vs))
            if len(streams) == 1:
                m.elements = streams[0]
            elif streams:
                m.voices = streams
                m.elements = sorted(
                    (e for s in streams for e in s),
                    key=lambda n: (n.offset, n.pitch.midi if isinstance(n, Note) else -1))
            bar_dur = None
            if cur_ts is not None:
                from musicnlp_tpu_torch.io.score import time_sig2bar_dur
                bar_dur = time_sig2bar_dur(cur_ts)
            content_end = max((e.end for e in m.elements), default=Fraction(0))
            bar_offset += bar_dur if bar_dur is not None else content_end
            part.measures.append(m)
        # reference is_drum_track (music_lib.py:301-320): a part whose notes
        # are all unpitched is percussion even off channel 10
        if n_unpitched and not n_pitched:
            part.is_drum = True
        score.parts.append(part)
    return score
