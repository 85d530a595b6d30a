"""Copy of `musicnlp_tpu/_sample_scores.py` (token strings): the port keeps its own copy
and imports nothing from the JAX package; the strings are the same
(held against the original by tests/test_torch_postprocess.py).

Hard-coded sample token strings used as fixtures.

Rebuild of the reference `musicnlp/_sample_score.py:1-40`: one small song in
all three pitch kinds plus a deliberately BROKEN generated sequence that
exercises the renderer's repair path (render-robustness; see the reference's
`music_converter.py:506-548` check).
"""

# 4 bars, full mode, midi pitch kind
sample_full_midi = (
    'TimeSig_4/4 Tempo_120 '
    '<bar> <melody> p_1/4 d_1 p_5/4 d_1 p_8/4 d_1 p_1/5 d_1 '
    '<bass> p_1/3 d_2 p_8/2 d_2 '
    '<bar> <melody> <tup> p_10/4 p_1/5 p_3/5 d_2 </tup> p_8/4 d_2 '
    '<bass> p_6/2 d_4 '
    '<bar> <melody> p_r d_1 p_5/4 d_1/2 p_6/4 d_1/2 p_8/4 d_2 '
    '<bass> p_8/2 d_2 p_1/3 d_2 '
    '<bar> <melody> p_1/5 d_4 <bass> p_1/3 d_4 </s>'
)

# same song, step pitch kind (letter spellings)
sample_full_step = (
    'TimeSig_4/4 Tempo_120 '
    '<bar> <melody> p_1/4_C d_1 p_5/4_E d_1 p_8/4_G d_1 p_1/5_C d_1 '
    '<bass> p_1/3_C d_2 p_8/2_G d_2 '
    '<bar> <melody> <tup> p_10/4_A p_1/5_C p_3/5_D d_2 </tup> p_8/4_G d_2 '
    '<bass> p_6/2_F d_4 '
    '<bar> <melody> p_r d_1 p_5/4_E d_1/2 p_6/4_F d_1/2 p_8/4_G d_2 '
    '<bass> p_8/2_G d_2 p_1/3_C d_2 '
    '<bar> <melody> p_1/5_C d_4 <bass> p_1/3_C d_4 </s>'
)

# same song, degree pitch kind in C major (C=1, D=2, E=3, F=4, G=5, A=6)
sample_full_degree = (
    'TimeSig_4/4 Tempo_120 Key_CMajor '
    '<bar> <melody> p_1/4_1 d_1 p_5/4_3 d_1 p_8/4_5 d_1 p_1/5_1 d_1 '
    '<bass> p_1/3_1 d_2 p_8/2_5 d_2 '
    '<bar> <melody> <tup> p_10/4_6 p_1/5_1 p_3/5_2 d_2 </tup> p_8/4_5 d_2 '
    '<bass> p_6/2_4 d_4 '
    '<bar> <melody> p_r d_1 p_5/4_3 d_1/2 p_6/4_4 d_1/2 p_8/4_5 d_2 '
    '<bass> p_8/2_5 d_2 p_1/3_1 d_2 '
    '<bar> <melody> p_1/5_1 d_4 <bass> p_1/3_1 d_4 </s>'
)

# Deliberately broken generation (midi kind): dangling pitch without duration,
# an unterminated tuplet, an empty bar, a stray duration token, and no </s> --
# everything the generation repair path must survive.
gen_broken = (
    'TimeSig_4/4 Tempo_120 '
    '<bar> <melody> p_1/4 d_1 p_5/4 '
    '<bar> <melody> <bass> '
    '<bar> <melody> <tup> p_8/4 p_1/5 '
    '<bar> d_2 <melody> p_8/4 d_2 p_3/4'
)
