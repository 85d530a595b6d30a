"""The kernel build's library digest and the SASS tensor-core counter, on the
CPU (no nvcc, no card)."""
import subprocess

import pytest

from musicnlp_tpu_torch.kernels import build as kb
from musicnlp_tpu_torch.tools import vpu_roofline as vr


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / 'csrc'
    src.mkdir()
    (src / 'k.cu').write_text('#include "h.cuh"\n')
    (src / 'h.cuh').write_text('// v1\n')
    monkeypatch.setattr(kb, 'CSRC', src)
    monkeypatch.setattr(kb, 'BUILD_DIR', tmp_path / 'build')

    def no_nvcc(*a, **k):
        raise AssertionError('nvcc must not run')
    monkeypatch.setattr(subprocess, 'Popen', no_nvcc)
    return src


def test_lib_path_follows_sources_and_headers(csrc):
    """Editing the source or any csrc/*.cuh header, or adding a header,
    names another library, so a stale build is never loaded."""
    first = kb.lib_path('k')
    assert kb.lib_path('k') == first
    (csrc / 'h.cuh').write_text('// v2\n')
    second = kb.lib_path('k')
    (csrc / 'other.cuh').write_text('// new\n')
    third = kb.lib_path('k')
    (csrc / 'k.cu').write_text('#include "h.cuh"\n// edited\n')
    assert len({first, second, third, kb.lib_path('k')}) == 4
    assert all(p.parent == kb.BUILD_DIR and p.name.startswith('libk-')
               for p in (first, second, third))


def test_build_all_reuses_a_built_library(csrc):
    """A library already built for the current digest is reused: no nvcc."""
    path = kb.lib_path('k')
    path.parent.mkdir(parents=True)
    path.write_bytes(b'')
    assert kb.build_all(('k',)) == {'k': dict(seconds=0.0, ptxas='', cached=True)}
    (csrc / 'h.cuh').write_text('// v2\n')
    with pytest.raises(AssertionError, match='nvcc must not run'):
        kb.build_all(('k',))


def test_count_mma_counts_tensor_core_instructions_per_function():
    sass = '''
        Function : _ZN12_GLOBAL__N_12tc8k2_dq_tcILi64EEEvPK13__nv_bfloat16
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*0120*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;
        /*0130*/              @!P0 HMMA.16816.F32.BF16 R8, R12, R22, R8 ;
        /*0140*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        Function : _ZN12_GLOBAL__N_114k2_dq_kernelIfLi64EEEvPKf
        /*0000*/                   FFMA R1, R2, R3, R1 ;
        /*0010*/                   LDS R4, [R5+0x10] ;
'''
    assert vr.count_mma(sass) == {'_ZN12_GLOBAL__N_12tc8k2_dq_tcILi64EEEvPK13__nv_bfloat16': 3,
                                  '_ZN12_GLOBAL__N_114k2_dq_kernelIfLi64EEEvPKf': 0}
