"""Copy of `musicnlp_tpu/io/__init__.py` (pure Python): the score IR, the MIDI and
MusicXML readers and writers.  The port keeps its own copy and imports nothing
from the JAX package; only the import paths differ (held against the original by
tests/test_torch_pipeline.py)."""
from musicnlp_tpu_torch.io.score import (
    Dur, Pitch, Note, Rest, Chord, SNote, ExtNote, Measure, Part, Score, TsTup,
    MIDI_SPELLING, midi2step_octave, note2dur, note2pitch, get_offset, get_end_qlen,
    flatten_notes, unpack_notes, time_sig2bar_dur, eps,
)
from musicnlp_tpu_torch.io.midi import read_midi, write_midi, PPQ
from musicnlp_tpu_torch.io.musicxml import (
    write_musicxml, write_mxl, read_musicxml, read_mxl, parse_file, DIVISIONS,
)
