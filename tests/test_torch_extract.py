"""Extraction in the port against the JAX package (pure Python and the native
MIDI kernel, on the CPU): `MusicExtractor` on the goldens in both modes, with
and without step pitches; the frozen `tests/goldens/extraction.json`; the
fast extractor and its own build of the C++ library; `MusicExport` (save each
and resume, error isolation, thread and spawned process pools) and the
`extract` command, compared by song; and a native library that cannot be
built raising where the JAX package falls back."""
import glob
import json
import os

import pytest

from musicnlp_tpu import cli as jcli
from musicnlp_tpu.preprocess.fast_extractor import FastMidiExtractor as JFast
from musicnlp_tpu.preprocess.music_export import MusicExport as JExport
from musicnlp_tpu.preprocess.music_extractor import MusicExtractor as JExtractor
from musicnlp_tpu.utils import config as jconfig
from musicnlp_tpu.utils import music_fs as jfs
from musicnlp_tpu_torch import cli, native
from musicnlp_tpu_torch.io import parse_file
from musicnlp_tpu_torch.preprocess import music_export as texport
from musicnlp_tpu_torch.preprocess.fast_extractor import FastMidiExtractor, fast_extract_available
from musicnlp_tpu_torch.preprocess.music_export import MusicExport
from musicnlp_tpu_torch.preprocess.music_extractor import MusicExtractor
from musicnlp_tpu_torch.utils import config as tconfig
from musicnlp_tpu_torch.utils import music_fs as tfs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, 'tests', 'goldens')
with open(os.path.join(GOLDEN_DIR, 'extraction.json')) as f:
    FROZEN = json.load(f)
NAMES = sorted(FROZEN)
XML = [os.path.join(GOLDEN_DIR, f'{n}.musicxml') for n in NAMES]
MID = [os.path.join(GOLDEN_DIR, f'{n}.mid') for n in NAMES]


def _record(out):
    return dict(score=out.score, title=out.title, duration=out.duration, keys=out.keys,
                warnings=out.warnings)


@pytest.mark.parametrize('step', [False, True])
@pytest.mark.parametrize('mode', ['full', 'melody'])
@pytest.mark.parametrize('name', NAMES)
def test_extractor_records_equal_jax(name, mode, step):
    """Tokens, keys, duration, title and warnings, from the MusicXML file."""
    path = os.path.join(GOLDEN_DIR, f'{name}.musicxml')
    kw = dict(mode=mode, with_pitch_step=step, warn_logger=True)
    call = dict(exp='str_join', return_meta=True, return_key=True)
    want = _record(JExtractor(**kw)(path, **call))
    got = _record(MusicExtractor(**kw)(path, **call))
    assert got == want
    assert want['warnings'] is not None and want['keys']


@pytest.mark.parametrize('mode', ['full', 'melody'])
@pytest.mark.parametrize('name', NAMES)
def test_extractor_equals_frozen_goldens(name, mode):
    got = MusicExtractor(mode=mode, warn_logger=True)(
        parse_file(os.path.join(GOLDEN_DIR, f'{name}.musicxml')), exp='str_join')
    assert got == FROZEN[name][mode]


@pytest.mark.parametrize('name', NAMES)
def test_fast_extractor_equals_jax_and_frozen(name):
    path = os.path.join(GOLDEN_DIR, f'{name}.mid')
    assert FastMidiExtractor(mode='full')(path) == FROZEN[name]['fast_full']
    assert FastMidiExtractor(mode='melody')(path) == JFast(mode='melody')(path)
    assert FastMidiExtractor(mode='full').extract_with_meta(path) == \
        JFast(mode='full').extract_with_meta(path)


def test_native_library_is_the_ports_own_build():
    """Built from the port's source into build/native/, digest-named; the
    package directories stay free of libraries."""
    lib = native.load_midi_extract_lib()
    path = native.lib_path('midi_extract')
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith('libmidi_extract-') and lib._name == str(path)
    assert native.BUILD_DIR.parts[-2:] == ('build', 'native')
    assert not glob.glob(os.path.join(REPO, 'musicnlp_tpu_torch', '**', '*.so'), recursive=True)
    assert fast_extract_available()


def test_unbuildable_native_source_raises(tmp_path, monkeypatch):
    """fast_midi=True with a source g++ refuses: the build error raises, with
    g++'s output, whatever halt_on_error says; the JAX `MusicExport` falls back to
    the Python extractor."""
    (tmp_path / 'midi_extract.cpp').write_text('this is not C++\n')
    monkeypatch.setattr(native, 'SRC_DIR', tmp_path)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native, '_LIBS', {})
    with pytest.raises(RuntimeError, match='g\\+\\+ failed for native/midi_extract.cpp'):
        MusicExport(mode='full')(MID[:2], save_each=False, halt_on_error=False, fast_midi=True)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        FastMidiExtractor()
    assert not fast_extract_available()
    # .musicxml inputs never need the library
    res = MusicExport(mode='full')(XML[:1], save_each=False, fast_midi=True)
    assert res['n_error'] == 0 and len(res['songs']) == 1


def _by_song(records):
    return {os.path.basename(r['song_path']): r for r in records}


@pytest.mark.parametrize('fast', [False, True])
def test_export_in_memory_equals_jax(fast):
    """Records from both kinds of file, compared by song, for the Python
    extractor and (on .mid files) the native one."""
    args = dict(with_pitch_step=True)
    want = JExport(mode='full', extractor_args=args)(XML + MID, save_each=False, fast_midi=fast)
    got = MusicExport(mode='full', extractor_args=args)(XML + MID, save_each=False,
                                                       fast_midi=fast)
    assert got['n_error'] == want['n_error'] == 0 and len(got['songs']) == 12
    assert _by_song(got['songs']) == _by_song(want['songs'])


@pytest.mark.parametrize('parallel_mode', ['thread', 'process'])
def test_export_save_each_resume_and_pools(tmp_path, parallel_mode):
    """save_each in a pool: the per-song JSON equals the JAX package's (its
    sequential run), compared by song; a second run skips every song; a
    broken file is one error record and the others are written."""
    bad = tmp_path / 'broken.mid'
    bad.write_bytes(b'not a midi file')
    songs = XML[:3] + MID[3:] + [str(bad)]      # one JSON per stem
    jdir, tdir = tmp_path / 'jax', tmp_path / 'torch'
    want = JExport(mode='melody')(songs, output_dir=str(jdir), halt_on_error=False)
    got = MusicExport(mode='melody')(songs, output_dir=str(tdir), parallel=2,
                                     parallel_mode=parallel_mode)
    for res in (want, got):
        assert (res['n_total'], res['n_error'], res['n_done'], res['n_skipped']) == (7, 1, 6, 0)
        assert res['errors'][0]['song_path'] == str(bad)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for fnm in os.listdir(jdir):
        assert json.loads((tdir / fnm).read_text()) == json.loads((jdir / fnm).read_text()), fnm
    again = MusicExport(mode='melody')(songs, output_dir=str(tdir), parallel=2,
                                       parallel_mode=parallel_mode)
    assert (again['n_skipped'], again['n_done'], again['n_error']) == (6, 0, 1)
    with pytest.raises(AssertionError, match='not a MIDI file'):     # halt_on_error
        MusicExport(mode='melody')([str(bad)], output_dir=str(tmp_path / 'halt'))


def test_process_pool_spawns(monkeypatch):
    """The port's process pools start workers by spawn, never by fork."""
    seen = {}
    real = texport.ProcessPoolExecutor

    def spy(*args, **kw):
        seen['method'] = kw['mp_context'].get_start_method()
        return real(*args, **kw)
    monkeypatch.setattr(texport, 'ProcessPoolExecutor', spy)
    res = MusicExport(mode='full')(XML[:2], save_each=False, parallel=2)
    assert seen['method'] == 'spawn' and len(res['songs']) == 2


def test_extract_command_equals_jax(tmp_path, capsys):
    """Same files, same arguments: the same stdout summary (less its seconds),
    per-song JSON, combined file and exit code; a glob that matches nothing
    exits 2 in both."""
    songs = XML[:3] + MID[3:]
    outs = {}
    for name, main in (('jax', jcli.main), ('torch', cli.main)):
        d = tmp_path / name
        assert main(['extract', *songs, '--out', str(d / 'json'), '--mode', 'full', '--jobs', '1',
                     '--combine', str(d / 'combined.json')]) == 0
        lines = capsys.readouterr().out.splitlines()
        summary = json.loads(lines[0])
        summary.pop('seconds')
        outs[name] = (summary, lines[1].replace(str(d), ''),
                      json.loads((d / 'combined.json').read_text()))
        assert main(['extract', str(tmp_path / 'none-*.mid'), '--out', str(d / 'x')]) == 2
    assert outs['torch'][:2] == outs['jax'][:2]
    assert outs['torch'][0] == dict(n_total=6, n_error=0, n_skipped=0, n_done=6)
    want, got = outs['jax'][2], outs['torch'][2]
    assert got['n_song'] == want['n_song'] == 6
    assert _by_song(got['music']) == _by_song(want['music'])
    assert all(s['score'].split()[2] == '<bar>' for s in got['music'])


def test_config_and_music_fs_copies(tmp_path, monkeypatch):
    """The registry, the dotted lookup, the path registry (the same dataset
    directories as the JAX package's, with or without MUSICNLP_TPU_BASE), the
    sharded file names and the conversion ledger."""
    assert tconfig.config_dict == jconfig.config_dict and tconfig.SEED == jconfig.SEED == 77
    assert texport.SEED == 77
    assert tconfig.sconfig('datasets.POP909.n_song') == 909
    assert tconfig.sconfig('datasets.nope', default=None) is None
    assert tconfig.u.dataset_path == jconfig.u.dataset_path
    monkeypatch.setenv('MUSICNLP_TPU_BASE', str(tmp_path))
    for name in ('POP909', 'LMD'):
        assert tconfig.PathRegistry().converted_dir(name) == \
            jconfig.PathRegistry().converted_dir(name)
    assert tconfig.PathRegistry().dataset_path == str(tmp_path / 'datasets')
    o2f, jo2f = tfs.Ordinal2Fnm(176640, ext='mxl'), jfs.Ordinal2Fnm(176640, ext='mxl')
    for i in (0, 9_999, 10_000, 176_639):
        assert o2f(i) == jo2f(i) and o2f(i, return_parts=True) == jo2f(i, return_parts=True)
    assert tfs.clean_dataset_paths(['a/x_y  - z.mid', 'b/solo.mid']) == \
        jfs.clean_dataset_paths(['a/x_y  - z.mid', 'b/solo.mid'])
    led = tfs.ConversionLedger(str(tmp_path / 'meta.csv'))
    led.record('a', 'converted', 'MS')
    led.record('b', 'error', detail='x')
    led.save()
    assert jfs.ConversionLedger(str(tmp_path / 'meta.csv')).summary() == \
        dict(converted=1, error=1)
    conv = tmp_path / 'datasets' / 'converted' / 'POP909'
    for sub, stem in (('LP', 'song1'), ('MS', 'song1'), ('LP', 'song2')):
        os.makedirs(conv / sub, exist_ok=True)
        (conv / sub / f'{stem}.mxl').write_bytes(b'')
    assert tfs.get_converted_song_paths('POP909') == jfs.get_converted_song_paths('POP909')
