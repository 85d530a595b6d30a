"""Copy of `musicnlp_tpu/utils/download.py` (pure Python): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_download.py).

Artifact fetching: converted corpora, processed datasets, tokenizers.

Reference counterpart: ``musicnlp/chore/download.py:21-49`` -- hard-coded
gdown Google-Drive fetchers run from a ``__main__`` block (skip-if-exists
download + unzip into the path registry's dirs).  Rebuilt here as a
declarative artifact registry over a stdlib ``urllib`` fetcher:

- ``ARTIFACTS`` mirrors the reference's inventory (per-backend converted
  corpora incl. the 3-way LMD/MuseScore split, full/melody processed
  datasets, the trained tokenizer bundle) with the same public Drive ids.
  Converted bundles extract under the dataset registry's
  ``converted_dir_nm`` dir so ``PathRegistry.converted_dir`` +
  ``MusicExport``'s recursive glob find them without a move step.
- Large public Drive files answer the first request with an HTML
  virus-scan interstitial (the reason the reference depends on gdown);
  ``fetch`` detects it, re-posts the embedded confirm form once, and
  raises a clear error if Drive still refuses (quota / permission).
- Everything is egress-gated: network failures raise
  ``EgressUnavailable`` with a remediation hint instead of raw urllib
  tracebacks (this build environment has zero egress, and HPC TPU
  workers commonly have none either).  ``file://`` URLs go through the
  exact same fetch -> checksum -> atomic-rename -> extract path, so the
  component is fully testable offline (tests/test_download.py).
- Downloads are atomic (``.tmp`` + rename, matching utils/checkpoint.py)
  and resumable by skip-if-exists like the reference's
  ``download_n_unzip``; a ``.extracted`` marker keeps the no-op resume
  path from re-unzipping multi-GB bundles; optional sha256 pinning is
  first-party (the reference verifies nothing) and a pin mismatch on an
  existing file triggers a re-fetch rather than a dead end.
"""
from __future__ import annotations

import hashlib
import http.client
import os
import re
import shutil
import urllib.error
import urllib.parse
import urllib.request
import zipfile
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .config import PathRegistry

__all__ = [
    'Artifact', 'ARTIFACTS', 'EgressUnavailable', 'gdrive_url',
    'fetch', 'fetch_and_extract', 'download_artifact', 'list_artifacts',
]


class EgressUnavailable(RuntimeError):
    """Raised when an artifact URL cannot be fetched (no egress, Drive
    refusal, or a non-zip response where a bundle was expected)."""


def gdrive_url(file_id: str) -> str:
    """Direct-download URL for a public Google Drive file id.

    The reference stores ``https://drive.google.com/uc?id=<id>``; the
    ``uc?export=download`` form serves small files directly and an HTML
    confirm page for large ones, which ``fetch`` follows (see
    ``_gdrive_confirm_url``).
    """
    return f'https://drive.google.com/uc?export=download&id={file_id}'


@dataclass(frozen=True)
class Artifact:
    """One downloadable bundle: n part URLs -> one extraction dir."""
    name: str                       # registry key, e.g. 'converted/POP909-MS'
    urls: Tuple[str, ...]           # 1+ zip parts, fetched in order
    kind: str                       # 'converted' | 'hf' | 'tokenizer'
    subdir: str = ''                # extraction subdir under the kind dir
    sha256: Tuple[Optional[str], ...] = ()   # optional per-part pins
    note: str = ''

    def dest_dir(self, paths: PathRegistry) -> str:
        base = {
            'converted': os.path.join(paths.dataset_path, 'converted'),
            'hf': os.path.join(paths.dataset_path, 'processed', 'hf'),
            'tokenizer': paths.tokenizer_path,
        }[self.kind]
        return os.path.join(base, self.subdir) if self.subdir else base


def _art(name, kind, ids, subdir='', note=''):
    return Artifact(name=name, kind=kind, subdir=subdir, note=note,
                    urls=tuple(gdrive_url(i) for i in ids))


#: The reference's shipped-artifact inventory (chore/download.py:21-49):
#: converted (MuseScore / Logic Pro rendered) corpora, extracted+processed
#: HF-layout datasets per extraction mode, and the trained tokenizer bundle.
#: Converted subdirs match config.py's `converted_dir_nm` so the pipeline's
#: recursive song glob (music_export.py) sees the files where they land.
ARTIFACTS: Dict[str, Artifact] = {a.name: a for a in [
    _art('converted/LMD-all', 'converted',
         ['1CyfKiVX83YdS4p7_4npk2xbDVJ68L0tg'], subdir='LMD',
         note='MuseScore+Logic Pro renders, one bundle (UMich mirror)'),
    _art('converted/LMD-MS', 'converted',
         ['1-ISc2u6Sxvs3LES4byx0KcNGGVYDZnxV',
          '1-QuDFxv9chnSJPNVwOG--p2ZpGx403qu',
          '1gX7nrT--MjLsdHuUQ58O8RHTgCFD9Gk7'],
         subdir='LMD', note='3-way split (Drive quota)'),
    _art('converted/LMD-LP', 'converted',
         ['1arBNznnWo3EFw4e0NdHi4Hih37Qex7Hl'], subdir='LMD'),
    _art('converted/MAESTRO-MS', 'converted',
         ['1fzmfS65BN84O_bF1v8dN2uFlrrpOzYaZ'], subdir='MAESTRO'),
    _art('converted/POP909-MS', 'converted',
         ['1XobTD6x88PIEKfrZ6IAzXjMaZmBZ0XqR'], subdir='POP909'),
    _art('hf/full-LMD', 'hf', ['16qDj2SJ8CoT4Tqacc3OZfsVZ6_6CDs1s']),
    _art('hf/full-MAESTRO', 'hf', ['1UaXtvqloFojNc1RnZ8ZqqqeKuSAbCjOC']),
    _art('hf/full-POP909', 'hf', ['1dSxBi8Z1If-HuiHP9eWaRQAjYiRUPgnN']),
    _art('hf/melody-LMD', 'hf', ['1l5v_KN3-d-i7lP0Xo-Ifj1ZEJbYCwUbO']),
    _art('hf/melody-MAESTRO', 'hf', ['1oiujQaeMUnd2-PmO7KIIsppVRo_eZtXz']),
    _art('hf/melody-POP909', 'hf', ['1F07h0JGTSYZSpzrGm9wP1pA2tB-6phsL']),
    _art('tokenizer/full-all', 'tokenizer',
         ['1rbQccozpAMjRWkjtKConka_DkCusxZsF'],
         note='trained WordPiece bundle'),
]}


def _download(url: str, tmp: str, timeout: float, chunk_bytes: int) -> None:
    """One streamed GET -> ``tmp``.  Network-side failures map to
    ``EgressUnavailable``; local write errors (disk full, permissions)
    propagate as themselves -- they are not an egress problem."""
    try:
        src = urllib.request.urlopen(url, timeout=timeout)
    except (urllib.error.URLError, TimeoutError, ConnectionError,
            http.client.HTTPException, ValueError) as e:
        raise EgressUnavailable(
            f'cannot fetch {url!r}: {e}. This environment may have no '
            f'network egress; obtain the file out-of-band (or pass a '
            f'file:// URL) and re-run.') from e
    try:
        with src, open(tmp, 'wb') as f:
            shutil.copyfileobj(src, f, chunk_bytes)
    except (TimeoutError, ConnectionError, http.client.HTTPException) as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise EgressUnavailable(
            f'connection lost fetching {url!r}: {e}') from e
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


_HIDDEN_INPUT_RE = re.compile(
    rb'<input[^>]+type="hidden"[^>]+name="([^"]+)"[^>]+value="([^"]*)"')
_FORM_ACTION_RE = re.compile(rb'<form[^>]+action="([^"]+)"')


def _gdrive_confirm_url(html: bytes) -> Optional[str]:
    """Follow-up URL embedded in Drive's large-file scan interstitial:
    the download form's action plus its hidden fields (id/export/confirm/
    uuid).  None if the page carries no download form (quota exceeded,
    permission denied)."""
    m = _FORM_ACTION_RE.search(html)
    if not m or b'download' not in m.group(1):
        return None
    action = m.group(1).decode('utf-8', 'replace').replace('&amp;', '&')
    fields = {k.decode('utf-8', 'replace'): v.decode('utf-8', 'replace')
              for k, v in _HIDDEN_INPUT_RE.findall(html)}
    if not fields:
        return action
    sep = '&' if '?' in action else '?'
    return action + sep + urllib.parse.urlencode(fields)


def _is_gdrive(url: str) -> bool:
    host = urllib.parse.urlsplit(url).netloc
    return host.endswith('drive.google.com') or host.endswith(
        'drive.usercontent.google.com')


def _looks_html(path: str) -> bool:
    with open(path, 'rb') as f:
        head = f.read(512).lstrip().lower()
    return head.startswith(b'<!doctype html') or head.startswith(b'<html')


def fetch(url: str, out_path: str, *, sha256: Optional[str] = None,
          force: bool = False, timeout: float = 60.0,
          chunk_bytes: int = 1 << 20) -> str:
    """Fetch ``url`` to ``out_path`` (atomic tmp+rename; skip if exists).

    An existing file that fails its sha256 pin is discarded and
    re-fetched.  Google Drive scan interstitials are followed once.
    """
    if os.path.exists(out_path) and not force:
        if not sha256:
            return out_path
        try:
            _verify(out_path, sha256)
            return out_path
        except ValueError:
            os.remove(out_path)               # stale/corrupt: re-fetch
    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    tmp = out_path + '.tmp'
    _download(url, tmp, timeout, chunk_bytes)
    if _is_gdrive(url) and _looks_html(tmp):
        with open(tmp, 'rb') as f:
            follow = _gdrive_confirm_url(f.read(1 << 20))
        os.remove(tmp)
        if follow is None:
            raise EgressUnavailable(
                f'Google Drive answered {url!r} with an HTML page and no '
                f'download form -- the file is quota-limited or not '
                f'link-shared.  Download it in a browser and place it at '
                f'{out_path!r}.')
        _download(follow, tmp, timeout, chunk_bytes)
        if _looks_html(tmp):
            os.remove(tmp)
            raise EgressUnavailable(
                f'Google Drive still answered HTML after the confirm '
                f'step for {url!r}; download it in a browser and place '
                f'it at {out_path!r}.')
    if sha256:
        try:
            _verify(tmp, sha256)
        except Exception:
            os.remove(tmp)
            raise
    os.replace(tmp, out_path)
    return out_path


def _verify(path: str, want: str) -> None:
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for blk in iter(lambda: f.read(1 << 20), b''):
            h.update(blk)
    got = h.hexdigest()
    if got != want:
        raise ValueError(f'sha256 mismatch for {path}: got {got}, '
                         f'expected {want}')


def fetch_and_extract(url: str, zip_path: str, extract_dir: str = None, *,
                      sha256: Optional[str] = None,
                      force: bool = False) -> str:
    """The reference's ``download_n_unzip``: fetch a zip, extract next to
    it.  A ``.extracted`` marker newer than the zip makes re-runs no-ops
    (no multi-GB re-unzip); a corrupt/non-zip download is removed so the
    next run re-fetches instead of tripping on skip-if-exists forever."""
    fetch(url, zip_path, sha256=sha256, force=force)
    ext = extract_dir or os.path.dirname(zip_path)
    marker = zip_path + '.extracted'
    if (not force and os.path.exists(marker)
            and os.path.getmtime(marker) >= os.path.getmtime(zip_path)):
        return ext
    os.makedirs(ext, exist_ok=True)
    try:
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(ext)
    except zipfile.BadZipFile as e:
        os.remove(zip_path)
        raise EgressUnavailable(
            f'{zip_path!r} is not a zip archive ({e}); the download was '
            f'likely an error page.  The file has been removed -- '
            f're-run to fetch again.') from e
    with open(marker, 'w') as f:
        f.write(url + '\n')
    return ext


def download_artifact(name: str, *, paths: PathRegistry = None,
                      registry: Dict[str, Artifact] = None,
                      force: bool = False) -> str:
    """Fetch + extract every part of a registered artifact; returns the
    extraction dir.  Multi-part artifacts (LMD-MS) land in one dir, the
    reference's split handling."""
    registry = ARTIFACTS if registry is None else registry
    if name not in registry:
        known = ', '.join(sorted(registry))
        raise LookupError(f'unknown artifact {name!r}; known: {known}')
    art = registry[name]
    paths = paths or PathRegistry()
    dest = art.dest_dir(paths)
    safe = art.name.replace('/', '_')
    for i, url in enumerate(art.urls):
        part = f'{safe}_part{i + 1}.zip' if len(art.urls) > 1 else f'{safe}.zip'
        sha = art.sha256[i] if i < len(art.sha256) else None
        fetch_and_extract(url, os.path.join(dest, part), dest,
                          sha256=sha, force=force)
    return dest


def list_artifacts(registry: Dict[str, Artifact] = None) -> str:
    registry = ARTIFACTS if registry is None else registry
    lines = []
    for name in sorted(registry):
        a = registry[name]
        parts = f'{len(a.urls)} parts' if len(a.urls) > 1 else '1 part'
        note = f'  ({a.note})' if a.note else ''
        lines.append(f'{name:28s} [{a.kind}] {parts}{note}')
    return '\n'.join(lines)
