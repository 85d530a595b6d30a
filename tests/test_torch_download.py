"""The port's artifact download (ROADMAP A.9), offline: every fetch goes
through `file://` URLs to zips built here -- the same fetch -> checksum ->
atomic rename -> unzip path a real URL takes -- and the `download` command
prints and exits as the JAX package's does."""
import dataclasses
import hashlib
import os
import pathlib
import urllib.parse
import zipfile

import pytest

from musicnlp_tpu import cli as jcli
from musicnlp_tpu.utils import download as jdl
from musicnlp_tpu_torch import cli
from musicnlp_tpu_torch.utils.config import PathRegistry
from musicnlp_tpu_torch.utils.download import (
    ARTIFACTS, Artifact, EgressUnavailable, _gdrive_confirm_url, download_artifact, fetch,
    fetch_and_extract, gdrive_url, list_artifacts,
)


def _make_zip(path, members):
    with zipfile.ZipFile(path, 'w') as zf:
        for name, text in members.items():
            zf.writestr(name, text)
    return pathlib.Path(path).as_uri()


def test_registry_equals_jax():
    assert list(ARTIFACTS) == list(jdl.ARTIFACTS)
    for name, a in ARTIFACTS.items():
        assert dataclasses.asdict(a) == dataclasses.asdict(jdl.ARTIFACTS[name])
    assert list_artifacts() == jdl.list_artifacts()
    assert gdrive_url('abc') == jdl.gdrive_url('abc')
    paths = PathRegistry('/base')
    assert [a.dest_dir(paths) for a in ARTIFACTS.values()] == \
        [a.dest_dir(jdl.PathRegistry('/base')) for a in jdl.ARTIFACTS.values()]


def test_fetch_and_extract_roundtrip(tmp_path):
    url = _make_zip(tmp_path / 'src.zip', {'a.json': '{"x": 1}', 'sub/b.mid': 'MThd'})
    dest = tmp_path / 'dl'
    assert fetch_and_extract(url, str(dest / 'bundle.zip')) == str(dest)
    assert (dest / 'bundle.zip.extracted').exists()
    assert (dest / 'a.json').read_text() == '{"x": 1}' and (dest / 'sub' / 'b.mid').exists()
    assert not (dest / 'bundle.zip.tmp').exists()


def test_fetch_skips_existing_and_force(tmp_path):
    src, out = tmp_path / 'f.bin', tmp_path / 'out.bin'
    src.write_bytes(b'v1')
    fetch(src.as_uri(), str(out))
    src.write_bytes(b'v2-changed')
    fetch(src.as_uri(), str(out))
    assert out.read_bytes() == b'v1'
    fetch(src.as_uri(), str(out), force=True)
    assert out.read_bytes() == b'v2-changed'


def test_fetch_checksum_and_stale_pin(tmp_path):
    src = tmp_path / 'f.bin'
    src.write_bytes(b'payload')
    fetch(src.as_uri(), str(tmp_path / 'ok.bin'), sha256=hashlib.sha256(b'payload').hexdigest())
    with pytest.raises(ValueError, match='sha256 mismatch'):
        fetch(src.as_uri(), str(tmp_path / 'bad.bin'), sha256='0' * 64)
    assert not (tmp_path / 'bad.bin').exists() and not (tmp_path / 'bad.bin.tmp').exists()
    out = tmp_path / 'out.bin'
    out.write_bytes(b'corrupt leftover')          # fails its pin: discarded, re-fetched
    fetch(src.as_uri(), str(out), sha256=hashlib.sha256(b'payload').hexdigest())
    assert out.read_bytes() == b'payload'


def test_unreachable_raises_egress_error(tmp_path):
    with pytest.raises(EgressUnavailable, match='cannot fetch'):
        fetch((tmp_path / 'nope.zip').as_uri(), str(tmp_path / 'out.zip'))
    assert not (tmp_path / 'out.zip.tmp').exists()


def test_corrupt_zip_removed_and_recoverable(tmp_path):
    bad = tmp_path / 'bad.bin'
    bad.write_bytes(b'this is not a zip')
    zp = tmp_path / 'dl' / 'bundle.zip'
    with pytest.raises(EgressUnavailable, match='not a zip'):
        fetch_and_extract(bad.as_uri(), str(zp))
    assert not zp.exists()
    fetch_and_extract(_make_zip(tmp_path / 'good.zip', {'ok.txt': 'yes'}), str(zp))
    assert (tmp_path / 'dl' / 'ok.txt').read_text() == 'yes'


def test_reextract_skipped_when_unchanged(tmp_path):
    url = _make_zip(tmp_path / 'src.zip', {'a.txt': 'v'})
    zp = tmp_path / 'dl' / 'bundle.zip'
    extracted = pathlib.Path(fetch_and_extract(url, str(zp))) / 'a.txt'
    extracted.write_text('user-modified')
    fetch_and_extract(url, str(zp))
    assert extracted.read_text() == 'user-modified'
    fetch_and_extract(url, str(zp), force=True)
    assert extracted.read_text() == 'v'


def test_gdrive_confirm_url_equals_jax():
    html = (b'<!DOCTYPE html><html><body><form id="download-form" '
            b'action="https://drive.usercontent.google.com/download" method="get">'
            b'<input type="hidden" name="id" value="FILEID">'
            b'<input type="hidden" name="export" value="download">'
            b'<input type="hidden" name="confirm" value="t">'
            b'<input type="hidden" name="uuid" value="u-1"></form></body></html>')
    url = _gdrive_confirm_url(html)
    assert url == jdl._gdrive_confirm_url(html)
    q = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(url).query))
    assert q == {'id': 'FILEID', 'export': 'download', 'confirm': 't', 'uuid': 'u-1'}
    assert _gdrive_confirm_url(b'<html><body>Quota exceeded</body>') is None


def test_download_artifact_multipart(tmp_path):
    u1 = _make_zip(tmp_path / 'p1.zip', {'one.json': '1'})
    u2 = _make_zip(tmp_path / 'p2.zip', {'two.json': '2'})
    sha = hashlib.sha256((tmp_path / 'p2.zip').read_bytes()).hexdigest()
    reg = {'converted/FAKE': Artifact(name='converted/FAKE', urls=(u1, u2), kind='converted',
                                      subdir='FAKE, MS', sha256=(None, sha))}
    paths = PathRegistry(str(tmp_path / 'base'))
    dest = download_artifact('converted/FAKE', paths=paths, registry=reg)
    assert dest == str(tmp_path / 'base' / 'datasets' / 'converted' / 'FAKE, MS')
    assert sorted(os.listdir(dest)) == [
        'converted_FAKE_part1.zip', 'converted_FAKE_part1.zip.extracted',
        'converted_FAKE_part2.zip', 'converted_FAKE_part2.zip.extracted',
        'one.json', 'two.json']
    with pytest.raises(LookupError, match='unknown artifact'):
        download_artifact('nope', paths=paths, registry=reg)


@pytest.mark.parametrize('argv', [['download'], ['download', 'no-such-artifact', '--base', '{}'],
                                  ['download', 'tokenizer/full-all', '--base', '{}']],
                         ids=['list', 'unknown', 'fetch'])
def test_cli_download_prints_and_exits_as_jax(argv, tmp_path, capsys, monkeypatch):
    """Listing, an unknown name (exit 1) and a registered artifact fetched
    through a `file://` URL (exit 0, the destination printed): the same
    stdout, stderr and exit code from both packages' commands."""
    url = _make_zip(tmp_path / 'tok.zip', {'tok.json': '{}'})
    for mod in (ARTIFACTS, jdl.ARTIFACTS):
        monkeypatch.setitem(mod, 'tokenizer/full-all', dataclasses.replace(
            mod['tokenizer/full-all'], urls=(url,)))
    runs = []
    for i, main in enumerate((cli.main, jcli.main)):
        base = tmp_path / f'base{i}'
        rc = main([a.format(base) for a in argv])
        out, err = capsys.readouterr()
        runs.append((rc, out.replace(str(base), '<base>'), err.replace(str(base), '<base>')))
    assert runs[0] == runs[1]
    rc, out, err = runs[0]
    if argv[1:2] == ['tokenizer/full-all']:
        assert rc == 0 and out.strip() == os.path.join('<base>', 'tokenizers')
        assert (tmp_path / 'base0' / 'tokenizers' / 'tok.json').exists()
    elif len(argv) > 1:
        assert rc == 1 and 'unknown artifact' in err
    else:
        assert rc == 0 and 'converted/LMD-MS' in out
