"""Copy of `musicnlp_tpu/preprocess/fast_extractor.py` (pure Python / numpy): the port
keeps its own copy and imports nothing from the JAX package (held against the
original by tests/test_torch_extract.py).  It runs the port's own build of the
C++ kernel (`musicnlp_tpu_torch/native`), whose loader raises when the library
cannot be built or loaded: `FastMidiExtractor()` raises then, and
`fast_extract_available()` answers False.

Fast MIDI -> token extraction via the native C++ kernel.

Wrapper over musicnlp_tpu_torch/native/midi_extract.cpp: parses Standard MIDI Files
and runs skyline + slot quantization natively, then renders the (pitch,
n_slots) runs to vocabulary tokens here.  Semantics mirror
preprocess/music_extractor.py on MIDI-sourced corpora (see the kernel's
header); the Python extractor remains the reference implementation and the
only path for MusicXML input and tuplet-bearing scores.

Intended for LMD-scale corpus encoding (176k songs): throughput is dominated
by file parsing, which the reference does through music21 (its stated
bottleneck, reference musicnlp/preprocess/music_extractor.py:182).
"""
from __future__ import annotations

import ctypes
import os
from fractions import Fraction
from typing import Dict, List, Optional, Union

import numpy as np

from musicnlp_tpu_torch.native import load_midi_extract_lib
from musicnlp_tpu_torch.vocab import MusicVocabulary, VocabType

__all__ = ['FastMidiExtractor', 'fast_extract_available']


def fast_extract_available() -> bool:
    """Whether the native library builds and loads here (a query: it never
    stands in for the library where one was asked for)."""
    try:
        load_midi_extract_lib()
    except (RuntimeError, OSError):
        return False
    return True


class FastMidiExtractor:
    def __init__(self, precision: int = 5, mode: str = 'full'):
        assert mode in ('melody', 'full')
        self.precision = precision
        self.mode = mode
        self.vocab = MusicVocabulary(precision=precision, pitch_kind='midi')
        self._lib = load_midi_extract_lib()
        self._slot = Fraction(4, 2 ** precision)

    def _runs2toks(self, runs: List, out: List[str]):
        v = self.vocab
        for pitch, n_slots in runs:
            dur = self._slot * int(n_slots)
            p_tok = v.rest if pitch < 0 else v.note2pitch_str(int(pitch))
            d_tok = v.meta2tok(VocabType.duration, dur)
            out.append(v.sanitize_rare_token(p_tok, for_midi=True))
            out.append(v.sanitize_rare_token(d_tok))

    def __call__(self, path_or_bytes: Union[str, bytes],
                 exp: str = 'str_join') -> Union[str, List[str]]:
        data = path_or_bytes
        if isinstance(data, str):
            with open(data, 'rb') as f:
                data = f.read()
        buf = np.frombuffer(data, dtype=np.uint8)
        out_cap = max(1 << 16, len(data) * 8)
        out = np.zeros(out_cap, np.int32)
        n = self._lib.me_extract(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            self.precision, 1 if self.mode == 'full' else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out_cap)
        if n == -1:
            raise ValueError('not a parseable Standard MIDI File')
        if n == -2:
            raise ValueError('song has no notes')
        assert n > 0, f'native extraction failed ({n})'
        s = out[:n]
        v = self.vocab
        n_bar, ts_n, ts_d, tempo = int(s[0]), int(s[1]), int(s[2]), int(s[3])
        toks: List[str] = [
            v.sanitize_rare_token(v.meta2tok(VocabType.time_sig, (ts_n, ts_d))),
            v.sanitize_rare_token(v.meta2tok(VocabType.tempo, tempo)),
        ]
        pos = 4
        for _ in range(n_bar):
            n_mel, n_bass = int(s[pos]), int(s[pos + 1])
            pos += 2
            runs_m = s[pos:pos + 2 * n_mel].reshape(n_mel, 2)
            pos += 2 * n_mel
            runs_b = s[pos:pos + 2 * n_bass].reshape(n_bass, 2)
            pos += 2 * n_bass
            toks.append(v.start_of_bar)
            if self.mode == 'full':
                toks.append(v.start_of_melody)
                self._runs2toks(runs_m.tolist(), toks)
                toks.append(v.start_of_bass)
                self._runs2toks(runs_b.tolist(), toks)
            else:
                self._runs2toks(runs_m.tolist(), toks)
        toks.append(v.end_of_song)
        assert pos == n
        return ' '.join(toks) if exp == 'str_join' else toks

    def extract_with_meta(self, path: str) -> Dict:
        """Full per-song record (MusicExtractorOutput-shaped dict): tokens +
        KeyFinder keys (from the token pitch histogram) + duration estimate."""
        from musicnlp_tpu_torch.preprocess.key_finder import KeyFinder

        text = self(path, exp='str_join')
        toks = text.split()
        v = self.vocab
        # pitch-class duration histogram straight from the tokens
        pc_dur = np.zeros(12)
        n_bar = 0
        tempo = 120
        bar_q = 4.0
        for i, t in enumerate(toks):
            typ = v.type(t)
            if t == v.start_of_bar:
                n_bar += 1
            elif typ == VocabType.tempo and t not in v.rare_tok2meta:
                tempo = int(v.tok2meta(t))
            elif typ == VocabType.time_sig and t not in v.rare_tok2meta:
                ts = v.tok2meta(t)
                bar_q = 4.0 * ts[0] / ts[1]
            elif typ == VocabType.pitch and t != v.rest and i + 1 < len(toks):
                d = toks[i + 1]
                if v.type(d) == VocabType.duration and d != v.rare_duration:
                    pc_dur[v.tok2meta(t) % 12] += float(Fraction(v.tok2meta(d)))
        keys = KeyFinder(pc_durations=pc_dur)(return_type='dict')
        title = os.path.splitext(os.path.basename(path))[0]
        duration = round(n_bar * bar_q * 60.0 / max(tempo, 1))
        return dict(score=text, title=title, duration=duration,
                    keys={k: float(c) for k, c in keys.items()}, warnings=[])
