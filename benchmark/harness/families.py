"""Finds a configuration's model family and its plain reference by name.

A configuration's `family` names `families/<family>.py`, which holds all
that the harness knows of the family: its weight layout (`layout`), its
work counts (`attention_calls`, `matmul_params`, `forward_flops`; a new
op's work function lives in its family's module and its calls come from
its `attention_calls`), whether the roofline of its calls can be read
(`roofline_readable`), the program's model and config classes as dotted
paths (`PROGRAM`; only `harness/program.py` resolves them) and the
widths of its CPU test cells (`TINY`).  A configuration's `reference`
names `reference/<reference>.py`.  A new family comes in as those files;
nothing here names one.
"""
from __future__ import annotations

import importlib
from typing import Dict


def _module(package: str, name: str, what: str):
    if not name.isidentifier():
        raise ValueError(f'{what} name {name!r} is not a module name')
    try:
        return importlib.import_module(f'benchmark.{package}.{name}')
    except ModuleNotFoundError as e:
        if e.name != f'benchmark.{package}.{name}':
            raise
        raise ModuleNotFoundError(f'no {what} {name!r}: add benchmark/{package}/{name}.py',
                                  name=e.name) from e


def get(name: str):
    """`families/<name>.py`."""
    return _module('families', name, 'model family')


def reference(config: Dict):
    """`reference/<config['reference']>.py`: the configuration's plain model."""
    return _module('reference', config['reference'], 'reference')

