"""The music token language: a copy of `musicnlp_tpu/vocab` (numpy only)."""
from musicnlp_tpu_torch.vocab.elm_type import (
    ElmType, Channel, MusicElement, Key, key_str2enum, enum2key_str, key_enum2tuple,
    key_str2ordinal, key_ordinal2str, key_ordinal2key_enum, key_offset_dict, OFFKEY_OFFSET,
    N_KEY, key_inkey_mask, key_tonic_pc, key_is_major,
)
from musicnlp_tpu_torch.vocab.music_vocab import (
    COMMON_TEMPOS, is_common_tempo, COMMON_TIME_SIGS, is_common_time_sig,
    get_common_time_sig_duration_bound, TEMPO_LOW_EDGE, TEMPO_HIGH_EDGE,
    WORDPIECE_CONTINUING_PREFIX, VocabType, MusicVocabulary, nrp,
)
from musicnlp_tpu_torch.vocab.music_tokenizer import MusicTokenizer

# A song is its token string (or token list)
Song = str
