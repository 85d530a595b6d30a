"""Finds what belongs to a cell by the names in `BENCHMARK.json`.

A cell (`workloads` entry) names a configuration (`configs/<file>`, listed
under `configs`), a traffic mix (`traffic/<mix>.json`) and holds limits of
its own (`limits/<cell>.json`).  A per-layer metric is read by
`metrics/<metric>.py`; an attention op's kernel names are every
`kernels/*.json` whose `op` names it, and its calls and their work come
from the `attention_calls` of the configuration's family
(`families/<family>.py`, found by `harness/families.py`).  A later cell,
mix, configuration, model family, metric or kernel name comes in as new
files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / 'BENCHMARK.json'

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
TOP_KEYS = ('command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer')
SOURCES = ('device_trace', 'program_span', 'program_counter', 'host_clock')


def load_manifest(path: Path = MANIFEST) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload with its configuration, traffic, limits and metrics."""
    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)

    @property
    def entry(self) -> str:
        return self.traffic['entry']

    @property
    def module(self):
        """`harness/entries/<entry>.py`: the entry's session, rate, reference,
        numbers and faults."""
        return importlib.import_module(f'benchmark.harness.entries.{self.entry}')


def _reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    if 'workloads' in metric:
        return cell in metric['workloads']
    return metric.get('moves', metric['name']) in e2e_names


def find_cell(name: str, manifest: Optional[Dict] = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell called `name`, its files read; raises KeyError if absent."""
    m = manifest or load_manifest(bench_dir.parent / 'BENCHMARK.json')
    w = next((w for w in m['workloads'] if w['name'] == name), None)
    if w is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    c = next(c for c in m['configs'] if c['name'] == w['config'])
    with open(bench_dir.parent / c['file']) as f:
        config = json.load(f)
    with open(bench_dir / 'traffic' / f'{w["traffic"]}.json') as f:
        traffic = json.load(f)
    with open(bench_dir / 'limits' / f'{name}.json') as f:
        limits = json.load(f)['limits']
    e2e = [e for e in m['end_to_end'] if 'workloads' not in e or name in e['workloads']]
    names = [e['name'] for e in e2e]
    per = [p for p in m['per_layer'] if _reports(p, name, names)]
    return Cell(name, config, traffic, limits, w['chips'], e2e, per)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """`read` of `metrics/<name>.py` (loaded by path: names hold dots)."""
    path = bench_dir / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + re.sub(r'[^A-Za-z0-9_]', '_', name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def op_kernels(bench_dir: Path = BENCH_DIR) -> Dict[str, List[str]]:
    """{op: kernel names} over every `kernels/*.json`."""
    out: Dict[str, List[str]] = {}
    for p in sorted((bench_dir / 'kernels').glob('*.json')):
        with open(p) as f:
            d = json.load(f)
        out.setdefault(d['op'], []).extend(d['kernels'])
    return out


def problems(m: Dict, root: Path = ROOT) -> List[str]:
    """What in a manifest breaks the benchmark contract's character and
    shape rules (an empty list when nothing does)."""
    bad = []
    if tuple(sorted(m)) != tuple(sorted(TOP_KEYS)):
        bad.append(f'top-level keys {sorted(m)}')
    if not (isinstance(m.get('command'), list) and 1 <= len(m['command']) <= 32):
        bad.append('command')
    for p in m.get('paths', []):
        if not PATH.match(p) or p.startswith('/') or '..' in p.split('/'):
            bad.append(f'path {p!r}')
    if not (isinstance(m.get('run_seconds'), int) and 1 <= m['run_seconds'] <= 51):
        bad.append('run_seconds')

    def text(s, what):
        if not (isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s and '\t' not in s):
            bad.append(f'{what} {s!r}')
    for w in m.get('command', []):
        text(w, 'command word')
    names = []
    for c in m.get('configs', []):
        if set(c) != {'name', 'source', 'file', 'reduced', 'why'}:
            bad.append(f'config keys {sorted(c)}')
        names.append(c['name'])
        text(c['source'], 'source')
        text(c['why'], 'why')
        if not any(c['file'].startswith(p.rstrip('/') + '/') for p in m['paths']):
            bad.append(f'config file {c["file"]} outside paths')
        if not (root / c['file']).is_file():
            bad.append(f'config file {c["file"]} missing')
        if len(c['reduced']) > 16 or not all(NAME.match(k) for k in c['reduced']):
            bad.append(f'reduced {c["reduced"]}')
    for w in m.get('workloads', []):
        if set(w) != {'name', 'config', 'traffic', 'chips', 'why'}:
            bad.append(f'workload keys {sorted(w)}')
        names.append(w['name'])
        for k in ('config', 'traffic'):
            if not NAME.match(w[k]):
                bad.append(f'{k} {w[k]!r}')
        if w['chips'] not in (1, 4):
            bad.append(f'chips {w["chips"]}')
        text(w['why'], 'why')
    metric_names = []
    for e in m.get('end_to_end', []):
        if not set(e) <= {'name', 'unit', 'better', 'bound', 'source', 'workloads'}:
            bad.append(f'end_to_end keys {sorted(e)}')
        if e['source'] not in ('host_clock', 'device_trace'):
            bad.append(f'end_to_end source {e["source"]}')
        if not 0.01 <= e['bound'] <= 0.25:
            bad.append(f'bound {e["name"]}')
        metric_names.append(e['name'])
    for p in m.get('per_layer', []):
        if not set(p) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}:
            bad.append(f'per_layer keys {sorted(p)}')
        if p['source'] not in SOURCES:
            bad.append(f'per_layer source {p["source"]}')
        text(p['layer'], 'layer')
        if p['moves'] not in [e['name'] for e in m['end_to_end']]:
            bad.append(f'{p["name"]} moves {p["moves"]}')
        metric_names.append(p['name'])
    for e in m.get('end_to_end', []) + m.get('per_layer', []):
        if not UNIT.match(e['unit']) or e['better'] not in ('lower', 'higher'):
            bad.append(f'unit / better of {e["name"]}')
    names += metric_names
    bad += [f'name {n!r}' for n in names if not NAME.match(n)]
    for group in ([c['name'] for c in m.get('configs', [])],
                  [w['name'] for w in m.get('workloads', [])], metric_names):
        if len(set(group)) != len(group):
            bad.append(f'duplicate names in {group}')
    if 'setup_s' not in metric_names:
        bad.append('no setup_s')
    return bad
