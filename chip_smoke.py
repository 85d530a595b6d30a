"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): `python3 chip_smoke.py`.

Drives the port's main paths -- TF-XL base training, scoring and generation
(the 22-11 recipe: d_model 768, 12 heads x 64, 12 layers, degree vocab 1190,
max_length 1024, mem_len 512, clamp_len 1024, bf16, batch 21, AdamW with
weight decay 0.1) and the Reformer's (the 22-04 recipe: base, d_model 768,
12 heads x 64, 12 layers alternating local and LSH attention, 2 hashes,
chunk 64, 64 buckets, midi vocab 422, max_length 2048, bf16, dropout 0.05,
batch 32, sampling with top_p 0.9), on weights made from a seed with numpy
in the JAX layout and carried in through `params_from_jax` -- and holds
every kernel of those paths against its plain PyTorch version on the card.

Phases (each prints a line; any failure raises and the exit code is not 0):
  1. device and build: the card's name and power limit, `nvcc` of every
     kernel source in `musicnlp_tpu_torch/csrc/`, all started together; the
     tensor-core instructions (HMMA / HGMMA) in the SASS of each K1-K4
     kernel -- the tensor-core kernels (every bf16 and f16 call of K1-K4
     up to head dim 128: k1_tc, k2_dkdv_tc / k2_dq_tc, k3_tc / k3_union_tc,
     k4_tc / k4_dq_tc / k4_dkdv_tc; and the slab kernels, every f32 call of
     K1-K4 and every call above 128: k1_slab, k2_dkdv_slab / k2_dq_slab,
     k3_slab, k4_dq_slab / k4_dkdv_slab, f32 in 3xTF32) must have some in
     their bf16 and their f16 instantiation (the slab kernels also in f32),
     and no other function but the backward's row-dot pass is left in the
     four libraries (no FMA kernel); each K1-K4 kernel's registers, local
     (spill) bytes, shared memory and blocks per SM at every head dim (K3 /
     K4 at chunks 16-128, D 16-128, 256 and 384) in f32 (the slab
     kernels), bf16 and f16, read from the loaded library (no spill
     allowed);
  2. K1 (forward) and K2 (backward) against their plain versions on CUDA
     tensors: the base shapes (scoring B 8 and training B 21, bf16 and f32),
     a memory + window case, a head-dim-16 ragged case, the 22-12 shape
     (TF-XL small: T 2048, full memory M 1024, clamp 1024, B 4, bf16) and
     the HF-imported TF-XL's window (same_length: window 512 at T 1024,
     clamp 1024; K1 B 8 without and with a full 512 memory, K2 at B 21 and
     with the memory, bf16, and an f32 B 2 memory case); times of each
     kernel, its plain version and a one-call PyTorch yardstick the port
     never calls (`scaled_dot_product_attention` with the positional term as
     a float mask; for K2 its backward, with the mask requiring grad); K2's
     achieved TFLOP/s (`k2_work`'s operations over its time); and the shapes
     ROADMAP C.1 widened the kernels to, at phase 11's shapes: head dim 128
     (B 2 x 8 heads, T 1024) in bf16 and f32, f16 at the 22-11 widths, an
     f16 head-dim-128 memory + window case, and head dim 128 in bf16 at the
     22-11 batch (B 21 x 6 heads, d_model 768) for K1 and for K2; and ROADMAP
     C.2's head dims above 128 on the slab kernels: 256 (B 2 x 4 heads) in
     bf16, f16 and f32, an f32 memory + window case, and 384 in bf16 and
     f32 (six output slabs in one block); the
     f32 cases' bounds at the FMA peak and at the 3xTF32 rate (495 / 3
     TFLOP/s) side by side;
  2c. the dense layers' epilogue kernel (`bias_act`: f32 bias, relu, one
     rounding) against its plain version at the FFN's shapes (w1 and w2 at
     65,536 tokens, w1 at 21,504) in bf16 with and without the relu and in
     f32, bit-equal; its time beside its byte bound and the plain version's,
     and the whole dense (f32 product + kernel) beside the chain it replaced
     and `torch.addmm`'s bias epilogue;
  3. the training path, counts set to 0 before and read after:
     `Trainer.train` for one epoch of 6 steps of 21 x 1024 seeded synthetic
     songs (dropout 0.1, warmup-cosine AdamW, eval with a padded final batch,
     a checkpoint), `load_trained` + `score_batch` on the run; a 20-step
     overfit on one batch; resume from the epoch-0 checkpoint against an
     uninterrupted run (dropout 0); one step at n_seg 2 (memory 512);
     step time, tokens/s, peak memory and a torch.profiler split of a step;
  4. the scoring and generation paths, counts set to 0 before and read
     after: `score_batch` (loss, NTP accuracy, IKR) on 8 x 1024 ids (12 K1,
     24 `bias_act`), then
     `MusicGenerator.generate` for 4 key-augmented unconditional prompts
     (sample, top_k 8, max_length 1024) with a bf16 and an int8 KV cache, and
     one greedy request with early exit, checked against the full-length run;
  5. the card against the port's own CPU run in f32: the loss at batch 1
     (12 layers) and one training step's gradients (depth 2, dropout 0);
     scoring throughput and a torch.profiler breakdown of one scoring batch
     and of 8 decode steps (device time by kernel, busy share);
  6. the Reformer, counts set to 0 before each path and read after: K3
     (forward) and K4 (backward, with an lse cotangent) against their plain
     versions were held in phase 2b (the 22-04 local and LSH shapes in bf16
     and f32, padded cases, a D 32 / chunk 32 single-block case, bf16
     D 16 and D 32 / chunk 32 padded cases; times of each kernel, its plain version and an
     SDPA yardstick over the unfolded windows; K4's achieved TFLOP/s; and
     the shapes C.1 added: chunk 128 at phase 11's local shape in f32
     and bf16 (k3_union_tc), chunk 128 / D 128 in bf16, the LSH shape in
     f16 (k3_tc), chunk 16 padded in f32 and in f16, and chunk 128 / D 128
     in f32 for K4; every f32 K3 / K4 call on the slab kernels; C.2's head
     dim 256 on the slab walks: the LSH shape at G 48 with pads in bf16,
     f16 and f32, and local cases in bf16 and f32);
     `Trainer.train` for 4 steps of 32 x 2048 synthetic songs (12 K3 + 12
     K4 launches per step), `load_trained` + `score_batch` on the
     run, step time, memory and a profile, a 15-step overfit; one f32 step
     at depth 2 on the card against the CPU (on shared branches); then
     `score_batch` at 8 x 2048 (12 K3 launches, no K4) and
     `MusicGenerator.generate` for 4 sampled songs (top_p 0.9) with a bf16
     and an int8 LSH cache (no kernel launch);
  7. K5 (the mask / softmax chain) and K6 (the multiply-add chain) against
     their plain versions at the roofline tool's shape (G 64 x [8, 64, 128]
     f32; K 4 and 32 with the tool's positions, K 4 mixed, K 32 and 1024
     with all-masked rows, which must read 1/128 exactly, and the timed
     K 1024 call itself), their times at K 1024 beside the plain versions'
     and the bound from the card's own lanes per pipe and clock (which must
     not exceed the time), K5's registers, spills (none allowed) and
     occupancy, the SASS of each loop (instructions per pass and per
     element, no call); then the roofline tool
     (`tools/vpu_roofline.roofline`, counts set to 0 before and read after)
     with phase 2b's K3 LSH time as its in-situ comparator, whose
     `mask_chain_share_of_k3` must lie in (0, 1);
  8. the user's path through the command line, in process (`cli.main`),
     counted, from raw files: 64 seeded synthetic songs rendered by the
     port's converter, 32 as .mxl and 32 as .mid -> `extract --jobs 4
     --combine` (worker processes spawned from this process, which holds
     the card; all 64 extracted, none shorter than 2048 tokens; its seconds
     and songs/s) -> the port's `MusicExtractor` (full, melody) and
     `FastMidiExtractor` (full) on tests/goldens/golden*.{musicxml,mid}
     against the frozen tests/goldens/extraction.json, byte for byte, and
     both extractors' songs/s on the 32 .mid files -> `dataset` (58 / 6)
     -> `train --recipe 22-11 --epochs 1` (2 steps of 21 x 1024 with key
     insertion, pitch shift, channel mixup and random crop; 12 K1 per
     forward, 12 K2 per step) -> `generate` (4 songs, top_k 8, and one
     conditioned on a rendered song with its key from `KeyFinder`) -> every
     written .mid / .mxl re-read by the port's io -> `generate` with beam
     search (4 beams), diverse-beam search (2 groups, diversity penalty
     1.0) and contrastive search (top_k 4, penalty_alpha 0.6), 2 songs
     each at max_length 1024, every file re-read, no K1 / K2 launch; two
     beam calls with the same arguments equal, contrastive (top_k 1,
     penalty_alpha 0) equal to greedy (128 tokens); then `train --recipe
     22-04 --epochs 1` (1 step of 32 x 2048; 12 K3 + 12 K4 per step) ->
     `generate` (4 songs, top_p 0.9) -> beam (4 beams) and contrastive
     search (top_k 4, penalty_alpha 0.6), 2 songs each at max_length 512
     (half the model's 2048, to bound the phase's time), every file
     re-read, no K3 / K4 launch, and the same exact checks; wall time per
     command, the epochs' tokens/s, decode tok/s (with phase 4's request
     repeated after the CLI's, in the same process state), each search
     command's peak device memory and the bytes a search step gathers or
     copies, the device-busy share of the recipes' own input pipeline
     feeding training steps, and the seconds of the raw-file, extraction
     and search parts;
  9. A.6 and A.4 on phase 8's dataset directory, counted: TF-XL base
     (vocab 1190, bf16) with an attention mask (8 x 1024, padded tails)
     and a training step with dropatt 0.1 (B 4) run the plain rel_attn
     (no K1 / K2), the unmasked forward 12 K1, the masked forward in f32 at
     B 1 against the port's CPU run; over the shipped 262,144-unit
     WordPiece table (8 x 1024, bf16, dropout 0) the tiled CE (head_chunk
     16384) against the dense CE on the same parameters and batch (loss,
     preds where the top two logits are apart, the embedding gradient,
     each one's step time and peak memory), then `Trainer.train` for one
     epoch (7 steps, 12 K1 per forward, 12 K2 per step) with
     `WordPieceMusicTokenizer.from_file` and `StringAugmentedDataset`
     (key insertion, pitch shift), a bare step's time, tokens/s and peak
     memory, the head's share of its device time and the busy share of
     the host pipeline feeding steps; the learned schemes through the
     command line with the dense head (`train --tokenizer-scheme wordpiece
     --tokenizer-path <the 262k table>`, base, 1024, batch 4, 1 epoch; a
     pair-merge table trained here on phase 8's songs and `train
     --tokenizer-scheme pairmerge`; `generate` 2 x 512 after each, every
     file re-read; wall seconds per command); the adaptive head (cutoffs
     (1000,), cluster parameters drawn with numpy): f32 log-probs at B 1
     on the card against the CPU, their logsumexp, 12 K1 per forward, and
     64 greedy decode steps in bf16 with no launch;
 10. A.7, counts set to 0 before each path and read after: an HF
     TransfoXLLMHeadModel checkpoint at the 22-11 widths (cutoffs [1000],
     same_length, mem_len 512; a state dict under HF's key names made with
     numpy) through `from_hf_transfo_xl` -> `score_batch` 8 x 1024 (12
     windowed K1), a forward over a full 512 memory (12 K1), f32 log-probs
     at B 1 card vs CPU and their logsumexp, save + `load_trained` +
     `MusicGenerator` 2 x 1024 (sample, top_k 8, no K1, every file
     re-read), and a 21 x 1024 step with `remat_attn` off and on (equal
     loss, gradients within 1e-4 of each leaf's max, K1 12 / 24 and K2 12,
     step ms and peak GiB each); an HF ReformerModelWithLMHead checkpoint
     at the 22-04 widths through `from_hf_reformer` (hf_compat) ->
     `score_batch` 8 x 2048 (12 K3), f32 logits at depth 2 card vs CPU, a
     32 x 2048 step with `remat` (24 K3, 12 K4), 2 sampled songs x 1024,
     128 greedy tokens through 'scan', the streamed scan (chunk 512) and
     'bounded' (window 32), each twice in mirrored order, with tok/s and
     peak memory each, in f32 at B 1 over 640 steps the streamed scan and
     'bounded' (window at least the largest bucket) against 'scan' on
     'scan''s bucket ids, a contrastive search over the [2 d] hidden; the native
     22-04 step at 32 x 2048 with `remat` off and on (K3 12 / 24, K4 12).
 11. C.1, A.8 and A.9, counts (K1-K4) set to 0 before each path and read
     after: a TF-XL at head dim 128 (d_model 1024, 8 heads) in f32 and
     bf16 and one in float16 (22-11 widths), depth 2, `score_batch` 2 x
     1024 (2 K1 each: k1_slab in f32, k1_tc in 16 bits), logits
     against the port's f32 CPU run (f32: 1e-4 of their max; bf16 / f16 at
     `TOL_16_LOGITS`, which a control with the attention dropped must
     exceed 4 times), an f32
     head-dim-128 step card vs CPU (K1 / K2); a Reformer with local_chunk
     128, depth 2: an f32 step card vs CPU (K3 / K4: the slab kernels) and
     `score_batch` 2 x 2048 (2 K3, traced: k3_slab twice, no other K3
     kernel);
     C.2, depth 2: TF-XLs
     at head dim 256 (d_model 1024, 4 heads) in f32 and bf16 and at 192
     (d_model 768, 4 heads, zero-padded to 256) in f32 and f16 score 2 x
     1024 on K1's slab kernel against the CPU as above, an f32 step of each
     card vs CPU (K1 / K2), an f32 Reformer step at head dim 256 (12 heads,
     local + LSH) card vs CPU (K3 / K4) and its bf16 `score_batch` 2 x 2048
     (2 K3); one 22-11
     `Trainer.train_step` (21 x 1024, bf16) inside `device_trace` after a
     traced warm-up step, 3 times, each Chrome trace naming k1_tc,
     k2_dkdv_tc and k2_dq_tc 12 times in the read step, `StepTimer` over 3
     more steps, and one 22-04 step at 2 x 2048 (12 K3, 12 K4); one bf16
     step of the head-dim-128 TF-XL (depth 2, 2 x 1024) and one of the
     chunk-128 Reformer (depth 2, 2 x 2048) traced the same way, naming
     k1_tc and k2_dkdv_tc / k2_dq_tc once per layer, k3_union_tc /
     k4_dq_tc / k4_dkdv_tc at the local layer and k3_tc / k4_tc at the LSH
     layer, and none of the slab kernels;
     on phase 8's run: `summarize_run` of its 22-04 train log, `MusicVisualize` reports and `MusicStats` of its
     generated songs, `ground_truth_ikr` of its dataset on the card and the
     CPU, melody grids of 8 rendered .mxl songs and `PitchEmbedding` trained
     on them on the card and on the CPU from one seed (emb_in within 1e-4
     of its max); `download` listing the registry, an artifact fetched from
     a `file://` zip with its sha256 pin, a wrong pin refused;
 12. multi-GPU training (`parallel/mesh.py`) on the one card: (a) a world
     of one process on NCCL (`init_distributed` from the launcher's
     environment), mesh (1, 1), 2 bf16 22-11 steps at 4 x 1024 against the
     mesh-free Trainer from one seed (losses, parameters), the step ms side
     by side, a traced step naming K1 / K2 12 times; (b) two spawned ranks
     on the card over gloo (NCCL takes one rank per device), mesh (data 1,
     model 2), f32, dropout 0, each check run on one device first and then
     at model 2 on its relu / LSH branches (`ShardedBranches`): a 22-11 step
     at 2 x 1024 (K1 / K2 on 6 local heads), a 22-04 step at 2 x 2048 (K3 /
     K4 on 6 local heads) -- loss, grad norm, every gradient, parameters --
     and `shard_vocab` over the 262k table (depth 2, 2 x 1024): loss, preds,
     gradients.
The line before the last holds the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json;
training runs write under build/chip_smoke_runs/, removed at the end.
Without CUDA, or without the package beside it, it fails before any result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
import zipfile
from types import SimpleNamespace

import numpy as np
import torch

from musicnlp_tpu_torch import cli
from musicnlp_tpu_torch.io import parse_file, read_midi
from musicnlp_tpu_torch.kernels.build import build_all, lib_path
from musicnlp_tpu_torch.models import reformer as reformer_module
from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import chunked_attention as ca
from musicnlp_tpu_torch.ops import chunked_attention_kernel as ck
from musicnlp_tpu_torch.ops import flash_attention as fa
from musicnlp_tpu_torch.ops import layers
from musicnlp_tpu_torch.ops import roofline_kernels as rk
from musicnlp_tpu_torch.ops.losses import chunked_shifted_ce_loss
from musicnlp_tpu_torch.postprocess import MusicStats, MusicVisualize, summarize_run
from musicnlp_tpu_torch.preprocess.dataset import (
    AugmentedDataset, SongDataset, StringAugmentedDataset, songdataset_to_dicts,
)
from musicnlp_tpu_torch.preprocess.fast_extractor import FastMidiExtractor
from musicnlp_tpu_torch.preprocess.key_finder import KeyFinder
from musicnlp_tpu_torch.preprocess.melody_grid import MelodyGridExtractor
from musicnlp_tpu_torch.preprocess.music_converter import MusicConverter
from musicnlp_tpu_torch.preprocess.music_extractor import MusicExtractor
from musicnlp_tpu_torch.tools import vpu_roofline as vr
from musicnlp_tpu_torch.trainer import train as tr
from musicnlp_tpu_torch.trainer.eval import MusicGenerator, load_trained, score_batch
from musicnlp_tpu_torch.trainer.melody_w2v import PitchEmbedding
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.trainer.pair_merge_tokenizer import PairMergeTokenizerTrainer
from musicnlp_tpu_torch.trainer.wordpiece_tokenizer import (
    WordPieceMusicTokenizer, WordPieceMusicTrainer,
)
from musicnlp_tpu_torch.utils import download
from musicnlp_tpu_torch.utils.checkpoint import flatten, params_from_jax, save_meta, save_pytree
from musicnlp_tpu_torch.utils.hf_import import from_hf_reformer, from_hf_transfo_xl
from musicnlp_tpu_torch.utils.prefetch import prefetch
from musicnlp_tpu_torch.utils.profiling import StepTimer, device_trace, step_kernels
from musicnlp_tpu_torch.vocab import MusicTokenizer, MusicVocabulary, N_KEY, key_ordinal2str

HBM_BYTES_PER_S = 3.35e12                        # H100 SXM (NVIDIA data sheet)
# dense bf16 / f16 tensor-core and f32 rates: the bound of an f16 or bf16
# call is its tensor-core time even where an FMA kernel runs it
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
TF32X3_FLOPS = 495e12 / 3                        # f32 as 3xTF32 on the tensor cores
SEED = 0
K1_REPLACES = 'musicnlp_tpu/ops/pallas/flash_attention.py:115 (_make_fwd, via _fwd_call :354)'
K2_REPLACES = ('musicnlp_tpu/ops/pallas/flash_attention.py:194 (_make_bwd_fused, via '
               '_flash_bwd :412)')
# K1 vs plain, per case: ctx (bf16 output rounding ~ 2^-8 of |ctx| <= ~3;
# p rounded against the running vs the global max) and lse (same f32 scores,
# other summation order)
TOL = {torch.float32: dict(ctx=1e-4, lse=1e-3), torch.bfloat16: dict(ctx=2e-2, lse=1e-3),
       torch.float16: dict(ctx=5e-3, lse=1e-3)}          # f16: 2^-11, 8x finer than bf16
# K2 vs plain, each output's largest error over its largest entry: f32 sums
# in other orders (dG by atomics, in an order that changes from run to run);
# bf16 also rounds p and ds to bf16, and a rounding that flips moves an ulp
TOL_K2 = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}
# card vs CPU f32 gradients, over each tensor's largest entry: the same f32
# arithmetic summed in other orders over 1024-2048 positions and two layers
# (the Reformer's on the same LSH buckets and relu branches, SharedBranches)
TOL_GRAD = 1e-4
K3_REPLACES = ('musicnlp_tpu/ops/pallas/chunked_attention_kernel.py:308 (_make_fwd, via '
               '_fwd_call :417)')
K4_REPLACES = ('musicnlp_tpu/ops/pallas/chunked_attention_kernel.py:336 (_make_bwd, via '
               '_core_bwd :449)')
# K3 vs plain: ctx (bf16 output rounding ~ 2^-8 of |ctx| <= ~3) and lse
# (the same f32 scores summed in another order)
TOL_K3 = TOL
# K4 vs plain, each output's largest error over its largest entry: f32 sums
# in other orders; bf16 also rounds p and ds, and a rounding that flips moves
# an ulp
TOL_K4 = TOL_K2
GEN_LEN = 1024                                   # Reformer generation length (tokens)
K5_REPLACES = 'scripts/vpu_roofline.py:39 (_mask_chain_kernel, via run_chain :90)'
K6_REPLACES = 'scripts/vpu_roofline.py:63 (_muladd_kernel, via run_muladd :111)'
ROOFLINE_K = 1024                                # passes of the timed K5 / K6 calls
BIAS_ACT_REPLACES = ('none: the f32 bias add, relu and one rounding after a dense product '
                     '(musicnlp_tpu/ops/layers.py:35 dense, :70 ffn), which '
                     'XLA fuses into the product on the TPU')
# the dense layers' epilogue at the main path's shapes: (rows, d_in, d_out)
# of the FFN's w1 and w2 at 65,536 tokens (scoring) and w1 at 21,504 (TF-XL
# training)
BIAS_ACT_SHAPES = ((65536, 768, 3072), (65536, 3072, 768), (21504, 768, 3072))
# K5 vs plain: each entry within one bf16 ulp (f32 sums in other orders,
# ex2.approx and one approximate reciprocal per row may flip a bf16
# rounding; an exact zero stays exact); K6 vs plain: bit-equal (the plain
# version's f64 product and sum are exact, so it rounds once per pass, as
# the FMA does)

# the tensor-core kernels of K1-K4, by name in each library's SASS: K1-K4
# run every call on the tensor cores (bf16 and f16 up to head dim 128 on
# k1_tc / k2_*_tc, on k3_tc / k4_tc at chunks 32 / 64 and D <= 64 and on the
# tiled walks k3_union_tc / k4_dq_tc + k4_dkdv_tc elsewhere; f32 at every
# head dim and 16 bits above 128 on the slab kernels, f32 in 3xTF32)
SLAB_KERNELS = {'flash_rel_attn_fwd': ('k1_slab',),
                'flash_rel_attn_bwd': ('k2_dkdv_slab', 'k2_dq_slab'),
                'chunked_window_attn_fwd': ('k3_slab',),
                'chunked_window_attn_bwd': ('k4_dq_slab', 'k4_dkdv_slab')}
TC_KERNELS = {'flash_rel_attn_fwd': ('k1_tc',) + SLAB_KERNELS['flash_rel_attn_fwd'],
              'flash_rel_attn_bwd': ('k2_dkdv_tc', 'k2_dq_tc') + SLAB_KERNELS['flash_rel_attn_bwd'],
              'chunked_window_attn_fwd': ('k3_tc', 'k3_union_tc')
              + SLAB_KERNELS['chunked_window_attn_fwd'],
              'chunked_window_attn_bwd': ('k4_tc', 'k4_dq_tc', 'k4_dkdv_tc')
              + SLAB_KERNELS['chunked_window_attn_bwd']}
# the libraries whose tensor-core kernels take both 16-bit types (all four),
# and each dtype's fragment of a mangled template name
BOTH_16_BIT = ('flash_rel_attn_fwd', 'flash_rel_attn_bwd', 'chunked_window_attn_fwd',
               'chunked_window_attn_bwd')
DTYPE_MANGLED = {torch.bfloat16: '__nv_bfloat16', torch.float16: '6__half',
                 torch.float32: 'If'}
SASS_MMA = {}                                    # library -> {function: HMMA + HGMMA}, phase 1
RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build', 'chip_smoke_runs')
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'chiprun_out')
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests', 'goldens')
# beam / contrastive generation length (tokens); 512 keeps the whole run
# well inside its 1,200 s limit (these host-paced searches spread most)
SEARCH_LEN = 512
EXACT_LEN = 128                                  # the exact search checks' length (tokens)
# the shipped 262,144-unit WordPiece table (degree pitches) and the tile of its tiled CE
TABLE_262K = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'artifacts',
                          'wordpiece_262144_degree.json.gz')
HEAD_CHUNK = 16384
# the tiled CE against the dense CE at V 262,144 in bf16: the same f32
# products of bf16 operands summed in other orders (the loss); the backward
# rounds the logits' gradient to bf16 (the embedding gradient, over its max)
TOL_HEAD = dict(loss=1e-3, embed_grad=2e-2)
# card vs CPU f32 logits / log-probs over their largest entry (TOL_GRAD's
# arithmetic over 1024 positions and 12 layers); the adaptive head's
# logsumexp per position
TOL_F32_LOGITS, TOL_LSE = 1e-4, 1e-5
# W_r's gradient (TF-XL's `attn/r`) between two bf16 training steps, over
# its largest entry: K2 sums the distance table's gradient with atomics in
# an order that changes from run to run, and its bf16 rounding may then
# flip.  The same step run twice with the same knob spread by up to 4.9e-3
# on an H100 (PERF.md); the bound is twice that, and the remat on / off gap
# and the off / off spread are each held to it
TOL_W_R = 1e-2
# the pause between a traced warm-up step and the traced step `step_kernels`
# reads after it: longer than any idle gap inside either step under the
# profiler (20 ms was not: a depth-2 step's host gaps, and once a 22-11
# warm-up step's, reached past it, and the read took in the warm-up's kernels)
TRACE_PAUSE_S = 0.25


def log(msg: str):
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile(fn) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler, CUPTI):
    wall time, summed kernel time, busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, 'self_device_time_total', None)
        if dev_us is None:
            dev_us = getattr(ev, 'self_cuda_time_total', 0.0)
        if dev_us > 0 and getattr(ev, 'device_type', None) != torch.autograd.DeviceType.CPU:
            rows.append(dict(name=ev.key, device_ms=dev_us / 1e3, count=ev.count))
    rows.sort(key=lambda r: -r['device_ms'])
    device_ms = sum(r['device_ms'] for r in rows)
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
                n_kernels=sum(r['count'] for r in rows), top=rows[:15])


def tensor_core_check(report):
    """HMMA / HGMMA instructions in the SASS of every K1-K4 kernel: each
    tensor-core kernel must have some in every instantiation (an FMA-only
    build is not the tensor-core design; the f32 slab kernels' 3xTF32 is
    HMMA too) and be instantiated for bf16 and for f16, the slab kernels
    also for f32 (they run every f32 call); no other function is left in a
    library but the backward's row-dot pass (delta), without tensor-core
    instructions."""
    for lib, tc_names in TC_KERNELS.items():
        SASS_MMA[lib] = counts = vr.tensor_core_counts(lib)
        for name in tc_names:
            fns = [c for f, c in counts.items() if name in f]
            if not fns or min(fns) == 0:
                raise AssertionError(f'{lib}: tensor-core instructions of {name}: {counts}')
            dtypes = (torch.bfloat16, torch.float16) + \
                ((torch.float32,) if name in SLAB_KERNELS[lib] else ())
            if lib in BOTH_16_BIT and not all(
                    any(name in f and DTYPE_MANGLED[d] in f for f in counts) for d in dtypes):
                raise AssertionError(f'{lib}: {name} is not built for {dtypes}: {counts}')
        other = {f: c for f, c in counts.items() if not any(n in f for n in tc_names)}
        if any(other.values()) or not all('row_dot' in f for f in other):
            raise AssertionError(f'{lib}: functions besides its tensor-core kernels: {other}')
    log(f'[sass] HMMA/HGMMA per kernel function: {json.dumps(SASS_MMA)}')
    report['sass_tensor_core_instructions'] = dict(SASS_MMA)


# (chunk, D) of K3's and K4's tensor-core kernels whose resources phase 1
# reads: the per-chunk kernels k3_tc / k4_tc and the tiled walks
CHUNK_RESOURCE_SHAPES = ((32, 16), (32, 32), (64, 64), (16, 32), (128, 64), (128, 128),
                         (64, 256), (64, 384))
# head dims above 128 whose slab kernels phase 1 reads (each dtype's
# instances: slab width 64, output slabs per block up to 256 columns, then
# up to 512, by each file's `with_cfg`)
WIDE_HEAD_DIMS = (256, 384)


def ptxas_spills(log: str) -> dict:
    """{mangled function: (spill store bytes, spill load bytes)} from the
    `-Xptxas=-v` output of an nvcc build."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            fn = m.group(1)
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m and fn:
            out[fn] = (int(m.group(1)), int(m.group(2)))
    return out


def kernel_resources(report, built):
    """Registers, local bytes (stack), dynamic shared memory and resident
    blocks per SM of each K1-K4 kernel at every head dim in f32, bf16 and
    f16 (K3 / K4 at `CHUNK_RESOURCE_SHAPES`), as the loaded libraries
    report them (`*_resources`: cudaFuncGetAttributes and the occupancy
    query), and the spill bytes ptxas reported for every instantiation in
    this run's build (`built`); raises if one spills or cannot run."""
    out = (ctypes.c_int * 10)()
    libs = {}
    for name in TC_KERNELS:
        libs[name] = ctypes.CDLL(str(lib_path(name)))
        fn = getattr(libs[name], f'{name}_resources')
        fn.argtypes = [ctypes.c_int] * (2 if name.startswith('flash') else 3) + [ctypes.c_void_p]
    k1, k2 = libs['flash_rel_attn_fwd'], libs['flash_rel_attn_bwd']
    k3, k4 = libs['chunked_window_attn_fwd'], libs['chunked_window_attn_bwd']
    rows = []

    def read(err, names, **shape):
        if err:
            raise AssertionError(f'resources of {names} at {shape}: CUDA error {err}')
        for i, name in enumerate(names):
            r = out[5 * i:5 * i + 5]
            rows.append(dict(kernel=name, **shape, registers=r[0], local_bytes=r[1],
                             smem_bytes=r[2], blocks_per_sm=r[3], threads=r[4]))
    for code, dt in ((0, 'f32'), (1, 'bf16'), (2, 'f16')):
        for H in fa.SMALL_HEAD_DIMS + WIDE_HEAD_DIMS:
            slab = code == 0 or H > 128
            read(k1.flash_rel_attn_fwd_resources(H, code, out),
                 ('k1_slab',) if slab else ('k1_tc',), dtype=dt, H=H)
            read(k2.flash_rel_attn_bwd_resources(H, code, out),
                 ('k2_dkdv_slab', 'k2_dq_slab') if slab else ('k2_dkdv_tc', 'k2_dq_tc'),
                 dtype=dt, H=H)
        for chunk, D in CHUNK_RESOURCE_SHAPES:
            per_chunk = chunk in (32, 64) and D <= 64
            slab = code == 0 or D > 128          # every f32 call on the slab kernels
            read(k3.chunked_window_attn_fwd_resources(chunk, D, code, out),
                 ('k3_slab',) if slab else ('k3_tc',) if per_chunk else ('k3_union_tc',),
                 dtype=dt, chunk=chunk, D=D)
            read(k4.chunked_window_attn_bwd_resources(chunk, D, code, out),
                 ('k4_dq_slab', 'k4_dkdv_slab') if slab else ('k4_tc',) if per_chunk
                 else ('k4_dq_tc', 'k4_dkdv_tc'), dtype=dt, chunk=chunk, D=D)
    for r in rows:
        log(f'[resources] {json.dumps(r)}')
    spills = {}
    for lib in BOTH_16_BIT:
        if built[lib]['cached']:
            log(f'[resources] {lib}: built before this run, ptxas spills not read')
            continue
        spills.update({f: sp for f, sp in ptxas_spills(built[lib]['ptxas']).items()
                       if any(n in f for n in TC_KERNELS[lib])})
    log(f'[resources] ptxas spill bytes (stores, loads) of {len(spills)} tensor-core K1-K4 '
        f'functions: {sorted(set(spills.values()))}')
    report['tensor_core_resources'] = dict(rows=rows, spills=spills)
    bad = [r for r in rows if r['blocks_per_sm'] < 1] + \
        [f for f, sp in spills.items() if any(sp)]
    if bad:
        raise AssertionError(f'tensor-core K1-K4 kernels that spill or cannot run: {bad}')


def mma_instructions(lib, dtype, D):
    """Tensor-core instructions of the kernels a call of `lib` at this dtype
    and head dim runs (`route_kernels`)."""
    names, frag = route_kernels(lib, dtype, D)
    return sum(c for f, c in SASS_MMA[lib].items()
               if frag in f and DTYPE_MANGLED[dtype] in f and any(n in f for n in names))


def route_kernels(lib, dtype, D):
    """(kernel names, a mangled template-argument fragment) of the kernels a
    call of `lib` at this dtype and head dim runs: the slab kernels above D
    128 and for every f32 call (K1 / K2 by slab width: min(D, 64), K2's f32
    slabs min(D, 32)); else the 16-bit tensor-core ones."""
    flash = lib.startswith('flash')
    if D > 128 or dtype == torch.float32:
        width = min(D, 32 if lib == 'flash_rel_attn_bwd' and dtype == torch.float32 else 64)
        return SLAB_KERNELS[lib], f'Li{width}E' if flash else ''
    return tuple(n for n in TC_KERNELS[lib] if n not in SLAB_KERNELS[lib]), f'Li{D}E'


def bounds(flops, nbytes, dtype) -> dict:
    """The least time of a call that does `flops` operations and moves
    `nbytes`: the larger of its operations at the dtype's peak and its bytes
    at the memory rate.  An f32 call also gets its bound at the 3xTF32 rate
    (495 / 3 TFLOP/s: three TF32 products per f32 product), the rate its
    tensor-core kernels (K1 / K2 at every head dim, K3 / K4 above 128) can
    reach, beside the FMA-peak bound of `bound_ms`."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    out = dict(bound_ms=max(t_ops, t_bytes),
               bound_by='operations' if t_ops >= t_bytes else 'bytes')
    if dtype == torch.float32:
        t_tf32 = flops / TF32X3_FLOPS * 1e3
        out.update(bound_3xtf32_ms=max(t_tf32, t_bytes),
                   bound_3xtf32_by='operations' if t_tf32 >= t_bytes else 'bytes')
    return out


# ------------------------------------------------------------------ K1 cases
def k1_inputs(dev, dtype, B, N, T, M, H, clamp, seed):
    g = torch.Generator(device='cpu').manual_seed(seed)
    S = M + T
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    Wr = (torch.randn(N * H, N, H, generator=g) * 0.02).to(dev)
    return (mk(B * N, T, H), mk(B * N, T, H), mk(B * N, S, H), mk(B * N, S, H),
            fa.distance_table(Wr, T, S, M, clamp, dtype))


def k1_work(rw, k, g, T, S, M, mem_valid, window, dtype):
    """(flops, bytes) this call needs: 3 H-long products (AC, BD, PV) per
    visible (q, k) pair; each input read once, each output written once."""
    BN, _, H = rw.shape
    visible = int(fa._key_mask(T, S, M, mem_valid, window, rw.device).sum())
    flops = 3 * 2 * H * visible * BN
    e = rw.element_size()
    nbytes = e * (2 * BN * T * H + 2 * BN * S * H + g.numel() + BN * T * H) + 4 * BN * T
    return flops, nbytes


def sdpa_yardstick(rw, rr, k, v, g, T, S, M, mem_valid, window, scale):
    """One PyTorch call for the same function: SDPA with BD*scale + mask as
    a float attn_mask (built outside the timed call)."""
    BN, N = rw.shape[0], g.shape[0]
    u = (T - 1 - torch.arange(T, device=rw.device)[:, None]
         + torch.arange(S, device=rw.device)[None, :])
    bias = torch.empty(BN, T, S, dtype=rw.dtype, device=rw.device)
    ok = fa._key_mask(T, S, M, mem_valid, window, rw.device)
    for b in range(BN):                           # [T, T+S] row at a time: bounded memory
        s1 = rr[b].float() @ g[b % N].float().T
        bias[b] = torch.where(ok, torch.gather(s1, 1, u) * scale,
                              torch.tensor(float('-inf'), device=rw.device)).to(rw.dtype)
    fn = lambda: torch.nn.functional.scaled_dot_product_attention(rw, k, v, attn_mask=bias,
                                                                  scale=scale)
    fn.bias = bias
    return fn


def k1_case(dev, name, dtype, B, N, T, M, H, clamp, mem_valid, window, seed, timed):
    rw, rr, k, v, g = k1_inputs(dev, dtype, B, N, T, M, H, clamp, seed)
    S = M + T
    scale = H ** -0.5
    mvt = torch.tensor(mem_valid, dtype=torch.int32, device=dev)
    saved = fa.LAUNCHES['flash_rel_attn_fwd']
    ctx, lse = fa.flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=scale, window=window)
    ref, ref_lse = fa.flash_rel_attn_fwd_plain(rw, rr, k, v, g, mvt, M=M, scale=scale,
                                               window=window)
    torch.cuda.synchronize()
    err = float((ctx.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    tol = TOL[dtype]
    rec = dict(case=name, dtype=str(dtype).split('.')[-1], BN=B * N, T=T, S=S, M=M, H=H,
               clamp=clamp, mem_valid=mem_valid, window=window, max_abs_err=err,
               lse_max_abs_err=lse_err, tol_ctx=tol['ctx'], tol_lse=tol['lse'],
               tensor_core_instructions=mma_instructions('flash_rel_attn_fwd', dtype, H))
    if timed:
        rec['ms'] = time_ms(lambda: fa.flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=scale,
                                                          window=window))
        rec['plain_ms'] = time_ms(lambda: fa.flash_rel_attn_fwd_plain(
            rw, rr, k, v, g, mvt, M=M, scale=scale, window=window), iters=3)
        rec['library_ms'] = time_ms(sdpa_yardstick(rw, rr, k, v, g, T, S, M, mem_valid,
                                                   window, scale))
        flops, nbytes = k1_work(rw, k, g, T, S, M, mem_valid, window, dtype)
        rec.update(flops=flops, bytes=nbytes, **bounds(flops, nbytes, dtype))
    fa.LAUNCHES['flash_rel_attn_fwd'] = saved    # comparison launches do not count
    log(f'[k1] {json.dumps(rec)}')
    if not (math.isfinite(err) and err <= tol['ctx'] and lse_err <= tol['lse']):
        raise AssertionError(f'K1 disagrees with its plain version in case {name}: '
                             f'ctx {err} (tol {tol["ctx"]}), lse {lse_err} (tol {tol["lse"]})')
    return rec


# ------------------------------------------------------------------ K2 cases
def k2_work(rw, k, g, T, S, M, mem_valid, window):
    """(flops, bytes) this call needs: 8 H-long products per visible (q, k)
    pair (scores AC and BD, dP, dV, dK, dRW, dRR, dG); inputs rw, rr, out,
    dO, k, v, G and lse read once (delta = dO . O is the call's own), outputs
    drw, drr (input dtype), dk, dv and dG (f32) written once."""
    BN, _, H = rw.shape
    visible = int(fa._key_mask(T, S, M, mem_valid, window, rw.device).sum())
    flops = 8 * 2 * H * visible * BN
    e = rw.element_size()
    nbytes = (e * (4 * BN * T * H + 2 * BN * S * H + g.numel()) + 4 * BN * T
              + e * 2 * BN * T * H + 4 * (2 * BN * S * H + g.numel()))
    return flops, nbytes


def sdpa_bwd_yardstick(rw, rr, k, v, g, d_out, T, S, M, mem_valid, window, scale):
    """One PyTorch call for the same gradients: the backward of SDPA with
    BD*scale + mask as a float attn_mask that requires grad (its gradient is
    dBD), the forward run once outside the timed call."""
    bias = sdpa_yardstick(rw, rr, k, v, g, T, S, M, mem_valid, window, scale).bias
    ins = [t.detach().requires_grad_(True) for t in (rw, k, v)] + [bias.requires_grad_(True)]
    out = torch.nn.functional.scaled_dot_product_attention(*ins[:3], attn_mask=ins[3],
                                                           scale=scale)
    grads = torch.autograd.grad(out, ins, d_out, retain_graph=True)
    if grads[3] is None:
        raise AssertionError('SDPA returned no gradient for its float mask')
    return lambda: torch.autograd.grad(out, ins, d_out, retain_graph=True)


def k2_case(dev, name, dtype, B, N, T, M, H, clamp, mem_valid, window, seed, timed):
    rw, rr, k, v, g = k1_inputs(dev, dtype, B, N, T, M, H, clamp, seed)
    S = M + T
    scale = H ** -0.5
    mvt = torch.tensor(mem_valid, dtype=torch.int32, device=dev)
    saved = dict(fa.LAUNCHES)
    out, lse = fa.flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=scale, window=window)
    d_out = k1_inputs(dev, dtype, B, N, T, 0, H, clamp, seed + 100)[0]
    args = (rw, rr, k, v, g, out, d_out, lse, mvt)
    kw = dict(M=M, scale=scale, window=window)
    got = fa.flash_rel_attn_bwd(*args, **kw)
    ref = fa.flash_rel_attn_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = {n: float((a.float() - b.float()).abs().max()) for n, a, b in
            zip(('drw', 'drr', 'dk', 'dv', 'dG'), got, ref)}
    rel = {n: errs[n] / max(float(b.float().abs().max()), 1e-30) for n, b in
           zip(('drw', 'drr', 'dk', 'dv', 'dG'), ref)}
    del got, ref
    rec = dict(case=name, dtype=str(dtype).split('.')[-1], BN=B * N, T=T, S=S, M=M, H=H,
               clamp=clamp, mem_valid=mem_valid, window=window, max_abs_err=max(errs.values()),
               abs_err=errs, rel_err=rel, tol_rel=TOL_K2[dtype],
               tensor_core_instructions=mma_instructions('flash_rel_attn_bwd', dtype, H))
    if timed:
        rec['ms'] = time_ms(lambda: fa.flash_rel_attn_bwd(*args, **kw))
        rec['plain_ms'] = time_ms(lambda: fa.flash_rel_attn_bwd_plain(*args, **kw), iters=3)
        rec['library_ms'] = time_ms(sdpa_bwd_yardstick(rw, rr, k, v, g, d_out, T, S, M,
                                                       mem_valid, window, scale))
        flops, nbytes = k2_work(rw, k, g, T, S, M, mem_valid, window)
        rec.update(flops=flops, bytes=nbytes, **bounds(flops, nbytes, dtype),
                   tflops=flops / rec['ms'] / 1e9)
    fa.LAUNCHES.update(saved)                    # comparison launches do not count
    log(f'[k2] {json.dumps(rec)}')
    torch.cuda.empty_cache()
    if not all(math.isfinite(e) and e <= TOL_K2[dtype] for e in rel.values()):
        raise AssertionError(f'K2 disagrees with its plain version in case {name}: {rel} '
                             f'(tol {TOL_K2[dtype]})')
    return rec


# ---------------------------------------------------------------- main path
def base_config(**kw) -> TransfoXLConfig:
    """The 22-11 recipe's model: TF-XL base, degree vocab, seq 1024, mem 512."""
    return TransfoXLConfig.from_size('base', **dict(dict(vocab_size=1190, max_length=1024,
                                                         mem_len=512, dropout=0.0), **kw))


def score_inputs(V, B, T, seed, dev):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.int64)).to(dev)
    return ids, ids.clone()


class SyntheticSongs:
    """Seeded synthetic songs in the Trainer's dataset contract: each row is
    TimeSig, Tempo, Key_* (with `insert_key`, so 'ins-key' IKR reads its key),
    then bars of a repeated (pitch, duration) motif, </s>, and a pad tail
    (labels -100); `key_scores` one-hot on the song's key."""

    def __init__(self, tok: MusicTokenizer, n: int, seed: int, length: int = 1024,
                 insert_key: bool = True):
        rng = np.random.default_rng(seed)
        t2i = tok.vocab.tok2id
        pitches = [i for t, i in t2i.items() if t.startswith('p_')]
        durs = [i for t, i in t2i.items() if t.startswith('d_')]
        self.ids = np.full((n, length), tok.pad_token_id, np.int32)
        self.key_scores = np.zeros((n, N_KEY), np.float32)
        for r in range(n):
            key = int(rng.integers(N_KEY))
            motif = [x for _ in range(8) for x in (rng.choice(pitches), rng.choice(durs))]
            body = []
            while len(body) < int(rng.integers(length // 2, length - 8)):
                body += [t2i['<bar>']] + motif
            row = [t2i['TimeSig_4/4'], t2i['Tempo_120']]
            if insert_key:
                row.append(t2i[f'Key_{key_ordinal2str[key]}'])
            row = (row + body)[:length - 1] + [tok.eos_token_id]
            self.ids[r, :len(row)] = row
            self.key_scores[r, key] = 1.0
        self.labels = np.where(self.ids == tok.pad_token_id, -100, self.ids).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def batches(self, batch_size, shuffle=True, seed=None, drop_last=True):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idx = order[i:i + batch_size]
            yield dict(input_ids=self.ids[idx], labels=self.labels[idx],
                       key_scores=self.key_scores[idx])


def train_args(**kw) -> tr.TrainArgs:
    """The 22-11 recipe's optimizer: the base preset (lr 3e-4, warmup-cosine)
    with batch 21 and weight decay 0.1."""
    return tr.TrainArgs.from_preset('transf-xl', 'base', **dict(tr.RECIPES['22-11']['train_args'],
                                                                **kw))


def step_log(run_dir):
    with open(os.path.join(run_dir, 'train_log.jsonl')) as f:
        return [json.loads(l) for l in f]


def training_path(dev, tok, report):
    """Phase 3: the training path at full width, counted."""
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    cfg = base_config(dropout=0.1)
    steps, B = 6, 21
    train = SyntheticSongs(tok, steps * B, SEED + 10)
    evald = SyntheticSongs(tok, B + 4, SEED + 11)             # a padded final eval batch
    n_eval_batches = 2
    run = os.path.join(RUN_DIR, 'train')
    trainer = tr.Trainer(TransfoXL(cfg), tok, train, evald, out_dir=run, ikr_mode='ins-key',
                         args=train_args(num_train_epochs=1, seed=SEED))
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train(params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    log_ = step_log(run)
    recs = [r for r in log_ if 'loss' in r]
    ep = [r for r in log_ if 'train_tokens_per_sec' in r][0]
    log(f'[train] 22-11 base, 21x1024, bf16, dropout 0.1: {len(recs)} steps in {wall:.1f} s '
        f'(eval + checkpoint included); losses {[round(r["loss"], 4) for r in recs]}; '
        f'grad_norm {[round(r["grad_norm"], 3) for r in recs]}; lr {[r["lr"] for r in recs]}; '
        f'eval {json.dumps({k: v for k, v in ep.items() if k.startswith("eval_")})}; '
        f'launches {launches}')
    if len(recs) != steps or not all(math.isfinite(r['loss']) and math.isfinite(r['grad_norm'])
                                     for r in recs):
        raise AssertionError(f'training steps missing or not finite: {recs}')
    if launches['flash_rel_attn_bwd'] != steps * cfg.n_layer or \
            launches['flash_rel_attn_fwd'] != (steps + n_eval_batches) * cfg.n_layer:
        raise AssertionError(f'expected {cfg.n_layer} K1 and K2 launches per step: {launches}')
    if not all(math.isfinite(ep[f'eval_{k}']) for k in ('loss', 'ntp_acc', 'ikr')) or \
            not 0 <= ep['eval_ikr'] <= 1:
        raise AssertionError(f'eval metrics out of range: {ep}')

    model, tparams, ttok = load_trained(run, device=dev)
    ids = torch.from_numpy(evald.ids[:8]).to(dev)
    sc = score_batch(model, tparams, ids, torch.from_numpy(evald.labels[:8]).to(dev),
                     IkrMetric(ttok, mode='ins-key'))
    sc = {k: float(v) for k, v in sc.items()}
    log(f'[train] load_trained + score_batch on the run: {json.dumps(sc)}')
    if not all(math.isfinite(v) for v in sc.values()) or sc['loss'] > math.log(cfg.vocab_size) + 1:
        raise AssertionError(f'scoring the trained run failed: {sc}')
    report['train'] = dict(steps=recs, epoch=ep, wall_s=wall, launches=launches, score=sc)
    del model, tparams

    # step time, throughput, peak memory and a profile of one step
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.batches(B, seed=1)).items()}
    state = trainer.opt.init(res['params'])
    step = lambda: trainer.train_step(res['params'], state, batch)
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(step, iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tok = int((batch['labels'] != -100).sum())
    prof = profile(step)
    top = ', '.join(f'{r["name"][:40]} {r["device_ms"]:.2f}' for r in prof['top'][:6])
    log(f'[train] step {ms:.1f} ms: {B * 1024 / ms * 1e3:.0f} tok/s ({n_tok / ms * 1e3:.0f} '
        f'non-pad tok/s); peak memory {peak:.1f} GiB; profile: wall {prof["wall_ms"]:.1f} ms, '
        f'device busy {prof["device_ms"]:.1f} ms ({prof["busy_share"]:.1%}); top: {top}')
    report['train'].update(step_ms=ms, tok_per_s=B * 1024 / ms * 1e3,
                           nonpad_tok_per_s=n_tok / ms * 1e3, peak_mem_gb=peak, profile=prof)
    del trainer, res, state, batch
    torch.cuda.empty_cache()

    # a 20-step overfit on one batch at a constant lr
    one = SyntheticSongs(tok, B, SEED + 12)
    run = os.path.join(RUN_DIR, 'overfit')
    trainer = tr.Trainer(TransfoXL(cfg), tok, one, None, out_dir=run, args=train_args(
        num_train_epochs=20, lr_scheduler_type='constant', learning_rate=1e-3,
        save_per_epoch=False, seed=SEED))
    trainer.train(params=params_from_jax(trainer.model.init_flat(SEED), dev))
    losses = [r['loss'] for r in step_log(run) if 'loss' in r]
    log(f'[train] overfit one batch, 20 steps, lr 1e-3 constant: {[round(l, 3) for l in losses]}')
    if not (len(losses) == 20 and losses[-1] < 0.8 * losses[0]):
        raise AssertionError(f'the loss did not fall on the overfit batch: {losses}')
    report['overfit_losses'] = losses
    del trainer
    torch.cuda.empty_cache()

    # resume from the epoch-0 checkpoint == an uninterrupted run (dropout 0)
    report['resume'] = resume_check(dev, tok)

    # one step at n_seg 2: segments of 512 over a memory of 512
    trainer = tr.Trainer(TransfoXL(base_config()), tok, train, None, out_dir=run,
                         args=train_args(n_seg=2, seed=SEED))
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    for t in flatten(params).values():
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.batches(B, seed=2)).items()}
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    mets = trainer.train_step(params, trainer.opt.init(params), batch)
    torch.cuda.synchronize()
    seg = dict(fa.LAUNCHES)
    mets = {k: float(v) for k, v in mets.items()}
    log(f'[train] n_seg 2 step (segment 512, memory 512): {json.dumps(mets)} launches {seg}')
    if seg != dict(flash_rel_attn_fwd=2 * cfg.n_layer, flash_rel_attn_bwd=2 * cfg.n_layer) or \
            not all(math.isfinite(v) for v in mets.values()):
        raise AssertionError(f'the n_seg 2 step did not run through K1 and K2: {seg} {mets}')
    report['n_seg2'] = dict(metrics=mets, launches=seg)
    del trainer, params, batch
    torch.cuda.empty_cache()
    return launches


def resume_check(dev, tok):
    """Two epochs of 2 steps uninterrupted, against a run killed in epoch 1
    and resumed from its epoch-0 checkpoint by a new Trainer.  K2 adds dG with
    atomics, in an order that changes from run to run, so the runs are not
    bit-equal: Adam's first steps divide g by |g|, so an entry whose gradient
    is near 0 may move by up to 2 lr per step in one run and not the other.
    Held: every entry within 2 * sum(lr), and the resumed epoch's logged
    losses within 1e-3 (relative) of the uninterrupted run's."""
    cfg, B = base_config(), 21
    data = SyntheticSongs(tok, 2 * B, SEED + 13)

    class Crash(SyntheticSongs):
        def __init__(self):
            self.__dict__.update(data.__dict__)

        def batches(self, batch_size, shuffle=True, seed=None, drop_last=True):
            if seed == SEED + 1:
                raise RuntimeError('killed in epoch 1')
            return super().batches(batch_size, shuffle, seed, drop_last)

    def trainer(name, ds):
        return tr.Trainer(TransfoXL(cfg), tok, ds, None, out_dir=os.path.join(RUN_DIR, name),
                          args=train_args(num_train_epochs=2, seed=SEED,
                                          load_best_model_at_end=False))
    full_tr = trainer('full', data)
    full = full_tr.train(params=params_from_jax(full_tr.model.init_flat(SEED), dev))
    part = trainer('part', Crash())
    try:
        part.train(params=params_from_jax(part.model.init_flat(SEED), dev))
        raise AssertionError('the interrupted run was not interrupted')
    except RuntimeError as e:
        if 'killed' not in str(e):
            raise
    resumed_tr = trainer('part', data)
    resumed = resumed_tr.train(resume_from=os.path.join(RUN_DIR, 'part', 'checkpoint-ep0'))
    a, b = ({k: t.detach() for k, t in flatten(r['params']).items()} for r in (full, resumed))
    diffs = {k: float((a[k] - b[k]).abs().max()) for k in a}
    n_diff = sum(int((a[k] != b[k]).sum()) for k in a)
    n_all = sum(t.numel() for t in a.values())
    lr_sum = sum(r['lr'] for r in step_log(os.path.join(RUN_DIR, 'full')) if 'loss' in r)
    la = [r['loss'] for r in step_log(os.path.join(RUN_DIR, 'full')) if 'loss' in r][2:]
    lb = [r['loss'] for r in step_log(os.path.join(RUN_DIR, 'part')) if 'loss' in r][-2:]
    worst = max(diffs, key=diffs.get)
    rec = dict(max_abs_diff=diffs[worst], worst=worst, entries_differing=n_diff,
               entries=n_all, lr_sum=lr_sum, losses_full=la, losses_resumed=lb,
               opt_count=(int(full['opt_state']['count']), int(resumed['opt_state']['count'])))
    log(f'[train] resume from epoch 0 vs uninterrupted (dropout 0): {json.dumps(rec)}')
    if rec['opt_count'] != (4, 4) or diffs[worst] > 2 * lr_sum or len(lb) != 2 or \
            any(abs(x - y) > 1e-3 * abs(x) for x, y in zip(la, lb)):
        raise AssertionError(f'the resumed run differs from the uninterrupted one: {rec}')
    for d in ('full', 'part'):
        shutil.rmtree(os.path.join(RUN_DIR, d))
    return rec


def card_vs_cpu_grads(dev, report, key='grads_card_vs_cpu', share_branches=False, **cfg_kw):
    """One training step's gradients in f32, base width (`cfg_kw` changes
    the configuration), depth 2, B 1, T 1024, dropout 0: the card (K1 + K2)
    against the port's CPU run (plain versions); with `share_branches` the
    CPU takes the card's FFN relu branches (`SharedBranches`)."""
    cfg = base_config(**dict(dict(dtype='float32', n_layer=2), **cfg_kw))
    rows = SyntheticSongs(MusicTokenizer(pitch_kind='degree'), 1, SEED + 14)
    ids, labels = torch.from_numpy(rows.ids), torch.from_numpy(rows.labels)
    flat = TransfoXL(cfg, device='cpu').init_flat(SEED)
    grads = []
    shared = SharedBranches() if share_branches else contextlib.nullcontext()
    with shared:
        for device in (dev, torch.device('cpu')):
            grads.append(_tfxl_step_grads(cfg, flat, device, ids, labels))
            if share_branches:
                shared.replay()                      # the CPU takes the card's branches
    (l_card, g_card), (l_cpu, g_cpu) = grads
    rel = {k: float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max().clamp(min=1e-30))
           for k in g_cpu}
    worst = max(rel, key=rel.get)
    flips = (f'; CPU relu branches that differ from the card\'s (the card\'s are used): '
             f'{shared.differ["relu"]} of {shared.total["relu"]}' if share_branches else '')
    log(f'[train] f32 step, depth 2, B 1 {cfg_kw or ""}: loss card {l_card:.7f} cpu '
        f'{l_cpu:.7f}; gradients worst {worst} {rel[worst]:.2e} of its largest entry (tol '
        f'{TOL_GRAD}){flips}')
    report[key] = dict(loss_card=l_card, loss_cpu=l_cpu, rel=rel)
    if share_branches:
        report[key].update(relu_differing=shared.differ['relu'], relu=shared.total['relu'])
    if rel[worst] > TOL_GRAD or abs(l_card - l_cpu) > 1e-4 * abs(l_cpu):
        raise AssertionError(f'card and CPU f32 gradients disagree: {worst} {rel[worst]}')


def _tfxl_step_grads(cfg, flat, device, ids, labels):
    """(loss, {leaf: gradient on the CPU}) of one f32 TF-XL step on `device`;
    on the card, through K1 and K2 once per layer."""
    model = TransfoXL(cfg, device=device)
    params = params_from_jax(flat, device)
    leaves = flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    saved = dict(fa.LAUNCHES)
    loss, _ = model.loss(params, ids.to(device), labels.to(device))
    g = torch.autograd.grad(loss, list(leaves.values()))
    if device.type == 'cuda' and (fa.LAUNCHES['flash_rel_attn_fwd'] - saved['flash_rel_attn_fwd'],
                                  fa.LAUNCHES['flash_rel_attn_bwd'] - saved['flash_rel_attn_bwd']
                                  ) != (cfg.n_layer, cfg.n_layer):
        raise AssertionError('the card step did not run through K1 and K2')
    fa.LAUNCHES.update(saved)
    return float(loss.detach()), {k: t.detach().cpu() for k, t in zip(leaves, g)}


def run_generation(model, params, tok, n_req, strategy, seed, **kw):
    gen = MusicGenerator(model, tok, params, augment_key=True)
    keys = ['CMajor', 'AMinor', 'EbMajor', 'F#Minor']
    prompts = [gen.unconditional_prompt(key=keys[i % 4]) for i in range(n_req)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = gen.generate(prompts, strategy=strategy, seed=seed, max_length=1024, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for p, t in zip(prompts, texts):
        toks = t.split()
        if not t.startswith(p) or len(toks) > 1024 or any(x not in tok.vocab.tok2id for x in toks):
            raise AssertionError(f'invalid generated token string: {t[:200]}')
    lens = [len(t.split()) for t in texts]
    new_tok = sum(n - len(p.split()) for n, p in zip(lens, prompts))
    return texts, lens, new_tok, dt


# -------------------------------------------------------------- K3 / K4 cases
def chunked_inputs(dev, dtype, G, T, D, lsh, pads, seed):
    """q, k, v [G, T, D] and int32 positions as the Reformer's layers hand them
    to K3: local layers in order; LSH layers shared-QK (k = q rms-normalised,
    carrying 1/sqrt(D)) with a random permutation of positions per row (the
    bucket sort's); the last `pads` positions as pad keys (kpos = T)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(G, T, D, generator=g, device=dev) for _ in range(3))
    if lsh:
        k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) / D ** 0.5
        qpos = torch.argsort(torch.rand(G, T, generator=g, device=dev), dim=-1)
    else:
        qpos = torch.arange(T, device=dev).expand(G, T)
    kpos = torch.where(qpos >= T - pads, torch.full_like(qpos, T), qpos) if pads else qpos
    return ([x.to(dtype) for x in (q, k, v)]
            + [p.to(torch.int32).contiguous() for p in (qpos, kpos)])


def chunked_flops(qpos, kpos, chunk, D, products):
    """Operations of a call: `products` D-long products per (query, key)
    pair that these positions make visible."""
    return products * 2 * D * ck.visible_pairs(qpos, kpos, chunk)


def sdpa_window_yardstick(q, k, v, qpos, kpos, chunk, scale, self_bias):
    """One PyTorch call for K3's function: SDPA over the unfolded windows,
    q [G*n, c, D] against k / v [G*n, 2c, D], the position mask and the self
    bias as one float mask built outside the timed call."""
    G, T, D = q.shape
    n = T // chunk
    qw = q.reshape(G * n, chunk, D)
    kw = ck._windows(k, chunk).reshape(G * n, 2 * chunk, D)
    vw = ck._windows(v, chunk).reshape(G * n, 2 * chunk, D)
    qp = qpos.reshape(G * n, chunk, 1)
    kp = ck._pos_windows(kpos, chunk).reshape(G * n, 1, 2 * chunk)
    zero = torch.zeros((), device=q.device)
    bias = torch.where(kp <= qp, torch.where(kp == qp, zero + self_bias, zero),
                       zero + ck.NEG_INF).to(q.dtype)
    fn = lambda: torch.nn.functional.scaled_dot_product_attention(qw, kw, vw, attn_mask=bias,
                                                                  scale=scale)
    fn.args = (qw, kw, vw, bias)
    return fn


def k3_case(dev, name, dtype, G, T, D, chunk, lsh, pads, seed, timed=True):
    q, k, v, qpos, kpos = chunked_inputs(dev, dtype, G, T, D, lsh, pads, seed)
    scale, self_bias = (1.0, ca.SELF_BIAS) if lsh else (D ** -0.5, 0.0)
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    saved = dict(ck.LAUNCHES)
    ctx, lse = ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw)
    ref, ref_lse = ck.chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    torch.cuda.synchronize()
    err = float((ctx.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    del ref, ref_lse
    tol = TOL_K3[dtype]
    rec = dict(case=name, dtype=str(dtype).split('.')[-1], G=G, T=T, D=D, chunk=chunk,
               lsh=lsh, pads=pads, max_abs_err=err, lse_max_abs_err=lse_err,
               tol_ctx=tol['ctx'], tol_lse=tol['lse'],
               tensor_core_instructions=mma_instructions('chunked_window_attn_fwd', dtype, D))
    if timed:
        rec['ms'] = time_ms(lambda: ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw))
        rec['plain_ms'] = time_ms(lambda: ck.chunked_window_attn_fwd_plain(q, k, v, qpos, kpos,
                                                                           **kw), iters=3)
        rec['library_ms'] = time_ms(sdpa_window_yardstick(q, k, v, qpos, kpos, **kw))
        e = q.element_size()
        # q, k, v and both positions read once; ctx and lse written once
        flops, nbytes = chunked_flops(qpos, kpos, chunk, D, 2), (4 * e * D + 3 * 4) * G * T
        rec.update(flops=flops, bytes=nbytes, **bounds(flops, nbytes, dtype))
    ck.LAUNCHES.update(saved)                    # comparison launches do not count
    log(f'[k3] {json.dumps(rec)}')
    torch.cuda.empty_cache()
    if not (math.isfinite(err) and err <= tol['ctx'] and lse_err <= tol['lse']):
        raise AssertionError(f'K3 disagrees with its plain version in case {name}: '
                             f'ctx {err} (tol {tol["ctx"]}), lse {lse_err} (tol {tol["lse"]})')
    return rec


def k4_case(dev, name, dtype, G, T, D, chunk, lsh, pads, seed, timed=True):
    q, k, v, qpos, kpos = chunked_inputs(dev, dtype, G, T, D, lsh, pads, seed)
    scale, self_bias = (1.0, ca.SELF_BIAS) if lsh else (D ** -0.5, 0.0)
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    saved = dict(ck.LAUNCHES)
    out, lse = ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    d_out = torch.randn(out.shape, generator=g, device=dev).to(dtype)
    d_lse = torch.randn(lse.shape, generator=g, device=dev)       # a nonzero lse cotangent
    args = (q, k, v, qpos, kpos, out, d_out, lse, d_lse)
    got = ck.chunked_window_attn_bwd(*args, **kw)
    ref = ck.chunked_window_attn_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    names = ('dq', 'dk', 'dv')
    errs = {n: float((a.float() - b.float()).abs().max()) for n, a, b in zip(names, got, ref)}
    rel = {n: errs[n] / max(float(b.float().abs().max()), 1e-30) for n, b in zip(names, ref)}
    del got, ref
    rec = dict(case=name, dtype=str(dtype).split('.')[-1], G=G, T=T, D=D, chunk=chunk,
               lsh=lsh, pads=pads, max_abs_err=max(errs.values()), abs_err=errs, rel_err=rel,
               tol_rel=TOL_K4[dtype],
               tensor_core_instructions=mma_instructions('chunked_window_attn_bwd', dtype, D))
    if timed:
        rec['ms'] = time_ms(lambda: ck.chunked_window_attn_bwd(*args, **kw))
        rec['plain_ms'] = time_ms(lambda: ck.chunked_window_attn_bwd_plain(*args, **kw),
                                  iters=3)
        ys = sdpa_window_yardstick(q, k, v, qpos, kpos, **kw)
        ins = [t.detach().requires_grad_(True) for t in ys.args[:3]]
        y = torch.nn.functional.scaled_dot_product_attention(*ins, attn_mask=ys.args[3],
                                                             scale=scale)
        d_y = d_out.reshape(y.shape)
        rec['library_ms'] = time_ms(lambda: torch.autograd.grad(y, ins, d_y, retain_graph=True))
        del ys, ins, y
        e = q.element_size()
        # q, k, v, out, dO (input dtype), positions, lse, dlse read once; dq in
        # the input dtype, dk and dv in f32 written once
        flops = chunked_flops(qpos, kpos, chunk, D, 5)
        nbytes = (6 * e * D + 4 * 4 + 2 * 4 * D) * G * T
        rec.update(flops=flops, bytes=nbytes, **bounds(flops, nbytes, dtype),
                   tflops=flops / rec['ms'] / 1e9)
    ck.LAUNCHES.update(saved)                    # comparison launches do not count
    log(f'[k4] {json.dumps(rec)}')
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) and x <= TOL_K4[dtype] for x in rel.values()):
        raise AssertionError(f'K4 disagrees with its plain version in case {name}: {rel} '
                             f'(tol {TOL_K4[dtype]})')
    return rec


# ------------------------------------------------------------ Reformer paths
def reformer_config(**kw) -> ReformerConfig:
    """The 22-04 recipe's model: Reformer base (d_model 768, 12 heads x 64,
    12 layers alternating local and LSH, 2 hashes, chunk 64, 64 buckets at
    2048), midi vocab 422, max_length 2048, bf16, dropout 0.05."""
    r = tr.RECIPES['22-04']
    return ReformerConfig.from_size(r['model_size'], vocab_size=422,
                                    max_length=r['max_length'], **kw)


def reformer_train_args(**kw) -> tr.TrainArgs:
    """The 22-04 recipe's optimizer: the Reformer base preset (lr 3e-4
    warmup-cosine, weight decay 1e-2, clip 1.0) at batch 32."""
    return tr.TrainArgs.from_preset('reformer', 'base',
                                    **dict(tr.RECIPES['22-04']['train_args'], **kw))


def reformer_training_path(dev, tok, report):
    """The Reformer's training path at full width, counted."""
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    cfg = reformer_config()
    n_layer = len(cfg.attn_layers)
    steps, B, T = 4, 32, cfg.max_length
    train = SyntheticSongs(tok, steps * B, SEED + 20, length=T, insert_key=False)
    evald = SyntheticSongs(tok, B + 4, SEED + 21, length=T, insert_key=False)
    n_eval_batches = 2
    run = os.path.join(RUN_DIR, 'reformer')
    trainer = tr.Trainer(Reformer(cfg), tok, train, evald, out_dir=run,
                         args=reformer_train_args(num_train_epochs=1, seed=SEED))
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train(params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    log_ = step_log(run)
    recs = [r for r in log_ if 'loss' in r]
    ep = [r for r in log_ if 'train_tokens_per_sec' in r][0]
    log(f'[reformer-train] 22-04 base, {B}x{T}, bf16, dropout 0.05: {len(recs)} steps in '
        f'{wall:.1f} s (eval + checkpoint included); losses '
        f'{[round(r["loss"], 4) for r in recs]}; grad_norm '
        f'{[round(r["grad_norm"], 3) for r in recs]}; lr {[r["lr"] for r in recs]}; eval '
        f'{json.dumps({k: v for k, v in ep.items() if k.startswith("eval_")})}; '
        f'launches {launches}')
    if len(recs) != steps or not all(math.isfinite(r['loss']) and math.isfinite(r['grad_norm'])
                                     for r in recs):
        raise AssertionError(f'Reformer training steps missing or not finite: {recs}')
    if launches != dict(chunked_window_attn_fwd=(steps + n_eval_batches) * n_layer,
                        chunked_window_attn_bwd=steps * n_layer):
        raise AssertionError(f'expected {n_layer} K3 and K4 launches per step: {launches}')
    if not all(math.isfinite(ep[f'eval_{k}']) for k in ('loss', 'ntp_acc', 'ikr')) or \
            not 0 <= ep['eval_ikr'] <= 1:
        raise AssertionError(f'Reformer eval metrics out of range: {ep}')
    with open(os.path.join(run, 'meta.json')) as f:
        if json.load(f)['model_name'] != 'reformer':
            raise AssertionError('meta.json does not name the Reformer')

    model, tparams, ttok = load_trained(run, device=dev)
    ids = torch.from_numpy(evald.ids[:8]).to(dev)
    sc = score_batch(model, tparams, ids, torch.from_numpy(evald.labels[:8]).to(dev),
                     IkrMetric(ttok, mode='vanilla'),
                     torch.from_numpy(evald.key_scores[:8]).to(dev))
    sc = {k: float(v) for k, v in sc.items()}
    log(f'[reformer-train] load_trained + score_batch on the run: {json.dumps(sc)}')
    if not isinstance(model, Reformer) or not all(math.isfinite(v) for v in sc.values()) or \
            sc['loss'] > math.log(cfg.vocab_size) + 1:
        raise AssertionError(f'scoring the trained Reformer run failed: {sc}')
    report['reformer_train'] = dict(steps=recs, epoch=ep, wall_s=wall, launches=launches,
                                    score=sc)
    del model, tparams

    # step time, throughput, peak memory and a profile of one step
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.batches(B, seed=1)).items()}
    state = trainer.opt.init(res['params'])
    step = lambda: trainer.train_step(res['params'], state, batch)
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(step, iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tok = int((batch['labels'] != -100).sum())
    prof = profile(step)
    top = ', '.join(f'{r["name"][:40]} {r["device_ms"]:.2f}' for r in prof['top'][:8])
    log(f'[reformer-train] step {ms:.1f} ms: {B * T / ms * 1e3:.0f} tok/s ({n_tok / ms * 1e3:.0f} '
        f'non-pad tok/s); peak memory {peak:.1f} GiB; profile: wall {prof["wall_ms"]:.1f} ms, '
        f'device busy {prof["device_ms"]:.1f} ms ({prof["busy_share"]:.1%}); top: {top}')
    report['reformer_train'].update(step_ms=ms, tok_per_s=B * T / ms * 1e3,
                                    nonpad_tok_per_s=n_tok / ms * 1e3, peak_mem_gb=peak,
                                    profile=prof)
    del trainer, res, state, batch
    torch.cuda.empty_cache()

    # a short overfit on one batch at a constant lr
    one = SyntheticSongs(tok, B, SEED + 22, length=T, insert_key=False)
    run = os.path.join(RUN_DIR, 'reformer-overfit')
    n_over = 15
    trainer = tr.Trainer(Reformer(cfg), tok, one, None, out_dir=run, args=reformer_train_args(
        num_train_epochs=n_over, lr_scheduler_type='constant', learning_rate=1e-3,
        save_per_epoch=False, seed=SEED))
    trainer.train(params=params_from_jax(trainer.model.init_flat(SEED), dev))
    losses = [r['loss'] for r in step_log(run) if 'loss' in r]
    log(f'[reformer-train] overfit one batch, {n_over} steps, lr 1e-3 constant: '
        f'{[round(l, 3) for l in losses]}')
    if not (len(losses) == n_over and losses[-1] < 0.8 * losses[0]):
        raise AssertionError(f'the Reformer loss did not fall on the overfit batch: {losses}')
    report['reformer_overfit_losses'] = losses
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    return launches


class SharedBranches:
    """Within the block, the two places where the Reformer branches on a
    computed value -- the LSH bucket argmax (`lsh_buckets`, in the forward and
    in the decode step) and the FFN relu (`dense(..., act='relu')`, taken
    here as `dense` without the relu and then the relu) -- keep what they
    compute in `seen`; with `replaying` set they use `recorded` instead (in
    order, moved to the run's device) and count the entries their own
    arithmetic would have changed.  The card and
    the CPU sum in other orders, so a hash on a near-tie may land in another
    bucket, and a relu input within rounding of 0 may take the other side of
    the kink, which moves that token's share of an FFN weight gradient by a
    whole entry; sharing both holds the runs to the same branches, so the
    gradients can be held at f32 summation-order tolerance."""

    def __init__(self):
        self.seen = dict(buckets=[], relu=[])
        self.recorded = dict(buckets=[], relu=[])
        self.replaying = False
        self.differ, self.total = dict(buckets=0, relu=0), dict(buckets=0, relu=0)
        self.real = (ca.lsh_buckets, layers.dense)

    def _share(self, kind, value):
        if not self.replaying:
            self.seen[kind].append(value)
            return value
        want = self.recorded[kind].pop(0).to(value.device)
        self.differ[kind] += int((want != value).sum())
        self.total[kind] += value.numel()
        return want

    def buckets(self, x, rots):
        return self._share('buckets', self.real[0](x, rots))

    def relu(self, x):
        return torch.where(self._share('relu', x > 0), x, torch.zeros_like(x))

    def dense(self, p, x, mesh=None, *, act=None):
        y = self.real[1](p, x, mesh)
        return self.relu(y) if act == 'relu' else y

    def replay(self):
        """Replay what the first run saw (again, for each later run)."""
        self.recorded = {k: list(v) for k, v in self.seen.items()}
        self.replaying = True

    def __enter__(self):
        ca.lsh_buckets = reformer_module.lsh_buckets = self.buckets
        layers.dense = reformer_module.dense = self.dense
        return self

    def __exit__(self, *exc):
        ca.lsh_buckets = reformer_module.lsh_buckets = self.real[0]
        layers.dense = reformer_module.dense = self.real[1]


def reformer_card_vs_cpu(dev, report, key='reformer_grads_card_vs_cpu', **cfg_kw):
    """One f32 training step's loss and gradients, base width, depth 2 (one
    local and one LSH layer; `cfg_kw` changes the configuration), B 1, T
    2048, dropout 0: the card (2 K3 + 2 K4) against the port's CPU run
    (plain versions), on the same branches (`SharedBranches`)."""
    cfg = reformer_config(**dict(dict(dtype='float32', attn_layers=('local', 'lsh')), **cfg_kw))
    rows = SyntheticSongs(MusicTokenizer(pitch_kind='midi'), 1, SEED + 23,
                          length=cfg.max_length, insert_key=False)
    ids, labels = torch.from_numpy(rows.ids), torch.from_numpy(rows.labels)
    flat = Reformer(cfg, device='cpu').init_flat(SEED)
    out = []
    with SharedBranches() as shared:
        for device in (dev, torch.device('cpu')):
            model = Reformer(cfg, device=device)
            params = params_from_jax(flat, device)
            leaves = flatten(params)
            for t in leaves.values():
                t.requires_grad_(True)
            saved = dict(ck.LAUNCHES)
            loss, _ = model.loss(params, ids.to(device), labels.to(device))
            g = torch.autograd.grad(loss, list(leaves.values()))
            if not out and (
                    ck.LAUNCHES['chunked_window_attn_fwd'] - saved['chunked_window_attn_fwd'],
                    ck.LAUNCHES['chunked_window_attn_bwd'] - saved['chunked_window_attn_bwd']
            ) != (2, 2):
                raise AssertionError('the card step did not run through K3 and K4')
            ck.LAUNCHES.update(saved)
            out.append((float(loss.detach()), {k: t.detach().cpu() for k, t in zip(leaves, g)}))
            shared.recorded, shared.replaying = shared.seen, True    # the CPU takes the card's
    (l_card, g_card), (l_cpu, g_cpu) = out
    rel = {k: float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max().clamp(min=1e-30))
           for k in g_cpu}
    worst = max(rel, key=rel.get)
    flips = {k: f'{shared.differ[k]} of {shared.total[k]}' for k in shared.total}
    log(f'[reformer-train] f32 step, depth 2, B 1 {cfg_kw or ""}: loss card {l_card:.7f} cpu '
        f'{l_cpu:.7f}; gradients worst {worst} {rel[worst]:.2e} of its largest entry (tol '
        f'{TOL_GRAD}); CPU branches that differ from the card\'s (the card\'s are used): {flips}')
    report[key] = dict(loss_card=l_card, loss_cpu=l_cpu, rel=rel,
                       branches_differing=shared.differ, branches=shared.total)
    if rel[worst] > TOL_GRAD or abs(l_card - l_cpu) > 1e-5 * abs(l_cpu):
        raise AssertionError(f'card and CPU f32 Reformer gradients disagree: {worst} '
                             f'{rel[worst]}')


def reformer_score_and_generate(dev, tok, report):
    """The Reformer's scoring and generation paths, counted, and their times."""
    cfg = reformer_config(dropout=0.0)
    model = Reformer(cfg)
    params = params_from_jax(model.init_flat(SEED), dev)
    ikr = IkrMetric(tok, mode='vanilla')
    ids, labels = score_inputs(cfg.vocab_size, 8, cfg.max_length, SEED + 2, dev)
    key_scores = torch.from_numpy(
        np.random.default_rng(SEED + 3).random((8, N_KEY)).astype(np.float32)).to(dev)
    n_layer = len(cfg.attn_layers)

    def score():
        return score_batch(model, params, ids, labels, ikr, key_scores)
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    mets = score()
    torch.cuda.synchronize()
    per_forward = dict(ck.LAUNCHES)
    mets = {k: float(v) for k, v in mets.items()}
    log(f'[reformer-score] base bf16 8x{cfg.max_length}: {json.dumps(mets)} launches '
        f'{per_forward}')
    if per_forward != dict(chunked_window_attn_fwd=n_layer, chunked_window_attn_bwd=0):
        raise AssertionError(f'expected {n_layer} K3 launches and no K4 in one forward: '
                             f'{per_forward}')
    if not all(math.isfinite(v) for v in mets.values()) or \
            abs(mets['loss'] - math.log(cfg.vocab_size)) > 0.5 or not 0 <= mets['ikr'] <= 1:
        raise AssertionError(f'Reformer scoring metrics out of range: {mets}')
    n_iter = 5
    ms = time_ms(score, iters=n_iter, warmup=1)
    if ck.LAUNCHES['chunked_window_attn_fwd'] != n_layer * (n_iter + 2):
        raise AssertionError('K3 launches per forward changed during the timing loop')
    score_prof = profile(score)
    top = ', '.join(f'{r["name"][:40]} {r["device_ms"]:.3f}' for r in score_prof['top'][:6])
    log(f'[reformer-score] throughput: {ms:.2f} ms/batch, {ids.numel() / ms * 1e3:.0f} tok/s; '
        f'profile: wall {score_prof["wall_ms"]:.2f} ms, device busy '
        f'{score_prof["device_ms"]:.2f} ms ({score_prof["busy_share"]:.1%}); top: {top}')

    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    gen_rec = {}
    for quant in (None, 'int8'):
        qmodel = Reformer(dataclasses.replace(cfg, decode_cache_quant=quant))
        gen = MusicGenerator(qmodel, tok, params)
        prompts = [gen.unconditional_prompt(time_sig=ts, tempo=tp) for ts, tp in
                   (((4, 4), 120), ((3, 4), 90), ((6, 8), 100), ((2, 4), 140))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts = gen.generate(prompts, strategy='sample', seed=SEED, max_length=GEN_LEN,
                             **{k: v for k, v in tr.RECIPES['22-04']['generation'].items()
                                if k != 'strategy'})
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for p, t in zip(prompts, texts):
            toks = t.split()
            if not t.startswith(p) or len(toks) > GEN_LEN or \
                    any(x not in tok.vocab.tok2id for x in toks):
                raise AssertionError(f'invalid generated token string: {t[:200]}')
        lens = [len(t.split()) for t in texts]
        new_tok = sum(n - len(p.split()) for n, p in zip(lens, prompts))
        label = quant or 'bf16'
        gen_rec[label] = dict(lengths=lens, new_tokens=new_tok, seconds=dt,
                              decode_tok_per_s=new_tok / dt, sample=texts[0][:160])
        log(f'[reformer-generate] sample top_p=0.9, {label} LSH cache, 4 requests: lengths '
            f'{lens}, {new_tok / dt:.1f} decode tok/s ({dt:.1f} s)')
    gen_launches = dict(ck.LAUNCHES)
    if any(gen_launches.values()):
        raise AssertionError(f'Reformer decode runs no kernel: {gen_launches}')
    dparams = model.compute_params(params)
    state = model.init_decode_state(4)
    tok_in = ids[:4, 0]
    for _ in range(4):                            # warm the decode path
        _, state = model.decode_step(dparams, tok_in, state)

    def decode8():
        nonlocal state
        for _ in range(8):
            _, state = model.decode_step(dparams, tok_in, state)
    decode_prof = profile(decode8)
    log(f'[profile] Reformer, 8 decode steps: wall {decode_prof["wall_ms"]:.2f} ms, device busy '
        f'{decode_prof["device_ms"]:.2f} ms ({decode_prof["busy_share"]:.1%})')
    report['reformer_score'] = dict(metrics=mets, launches=per_forward, ms=ms,
                                    tok_per_s=ids.numel() / ms * 1e3, profile=score_prof)
    report['reformer_generate'] = dict(runs=gen_rec, launches=gen_launches,
                                       profile_decode=decode_prof)
    return per_forward


# ------------------------------------------------------------ K5 / K6 (phase 7)
def bias_act_phase(dev, report):
    """Phase 2c: the dense layers' epilogue kernel (`csrc/bias_act.cu`)
    against its plain version at the main path's shapes (`BIAS_ACT_SHAPES`)
    in bf16 with and without the relu, and in f32, on a nonzero bias: the
    same f32 add and one rounding, so bit-equal.  Times of the kernel, its
    bound (the f32 product read once, the output written once), the plain
    version, and the whole dense: the f32 product + the kernel, the chain it
    replaced (a bf16 product upcast, the f32 bias add, the cast back, relu)
    and `torch.addmm`'s bias epilogue (cuBLASLt; a bf16 bias), a library
    yardstick the port never calls."""
    g = torch.Generator(device='cpu').manual_seed(SEED + 60)
    saved = dict(layers.LAUNCHES)
    cases = []
    for n, d_in, d_out in BIAS_ACT_SHAPES:
        x = torch.randn(n, d_in, generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(d_in, d_out, generator=g) * 0.02).to(dev)
        b = (torch.randn(d_out, generator=g) * 0.02).to(dev)
        wc = w.to(torch.bfloat16)
        y = layers.f32_product(x, wc)
        for dtype, act in ((torch.bfloat16, 'relu'), (torch.bfloat16, None),
                           (torch.float32, 'relu')):
            got = layers.bias_act(y, b, act, dtype)
            want = layers.bias_act_plain(y, b, act, dtype)
            torch.cuda.synchronize()
            rec = dict(case=f'{n}x{d_out}-{str(dtype).split(".")[-1]}-{act or "none"}',
                       max_abs_err=float((got.float() - want.float()).abs().max()),
                       bit_equal=bool(torch.equal(got, want)))
            del got, want
            if not rec['bit_equal']:
                raise AssertionError(f'bias_act disagrees with its plain version: {rec}')
            if dtype == torch.bfloat16:
                # y read once, the output written once (the bias: d_out f32)
                nbytes = n * d_out * (4 + 2) + 4 * d_out
                rec.update(bytes=nbytes, **bounds(0, nbytes, dtype))
                rec['ms'] = time_ms(lambda: layers.bias_act(y, b, act, dtype), iters=20)
                rec['plain_ms'] = time_ms(lambda: layers.bias_act_plain(y, b, act, dtype))
                rec['share_of_bound'] = rec['bound_ms'] / rec['ms']
                relu = torch.relu if act else (lambda t: t)
                fused = lambda: layers.dense(dict(w=w, b=b), x, act=act)
                old = lambda: relu(((x @ wc).float() + b).to(torch.bfloat16))
                bb = b.to(torch.bfloat16)
                rec.update(product_ms=time_ms(lambda: layers.f32_product(x, wc), iters=20),
                           dense_ms=time_ms(fused, iters=20),
                           old_chain_ms=time_ms(old, iters=20),
                           library_ms=time_ms(lambda: relu(torch.addmm(bb, x, wc)), iters=20))
                if rec['share_of_bound'] > 1:
                    raise AssertionError(f'bias_act faster than its bound: {rec}')
            log(f'[bias_act] {json.dumps(rec)}')
            cases.append(rec)
        del x, y
        torch.cuda.empty_cache()
    layers.LAUNCHES.update(saved)                # comparison launches do not count
    report['bias_act_cases'] = cases
    return cases


def roofline_phase(dev, k3_ms, report):
    """Phase 7: K5 and K6 against their plain versions, their times and
    bounds at K = ROOFLINE_K, K5's registers, spills, occupancy and the SASS
    of both loops, then the roofline tool (the kernels' main path), counted."""
    s, kp, qp = vr.chain_inputs(dev, seed=SEED)
    # a second set of positions where masked, valid and self keys all shape a
    # row (the tool's positions make every row's softmax its self key), and a
    # third where every key of every even m is masked (p = 1/128 exactly)
    kp_mixed = (torch.arange(rk.W, dtype=torch.int32, device=dev) - 40).expand_as(kp).clone()
    kp_mixed[:, :, ::5] = 10 ** 6
    kp_masked = kp_mixed.clone()
    kp_masked[:, ::2] = 10 ** 6
    saved = dict(rk.LAUNCHES)
    checks, err5, err6 = [], 0.0, 0.0
    for K, kpos, label in ((4, kp, 'tool'), (32, kp, 'tool'), (4, kp_mixed, 'mixed'),
                           (32, kp_masked, 'all-masked rows'),
                           (ROOFLINE_K, kp_masked, 'all-masked rows'),
                           (ROOFLINE_K, kp, 'tool: the timed call')):
        got5, want5 = rk.mask_chain(s, kpos, qp, K), rk.mask_chain_plain(s, kpos, qp, K)
        got6, want6 = rk.muladd_chain(s, K), rk.muladd_chain_plain(s, K)
        torch.cuda.synchronize()
        d5, d6 = (got5 - want5).abs(), (got6 - want6).abs()
        rec = dict(K=K, positions=label, k5_max_abs_err=float(d5.max()),
                   k5_within_one_bf16_ulp=bool((d5 <= 2.0 ** -7 * want5.abs()).all()),
                   k5_bit_equal_share=float((got5 == want5).float().mean()),
                   k6_max_abs_err=float(d6.max()),
                   k6_rel_err=float(d6.max()) / max(float(want6.abs().max()), 1e-30))
        if kpos is kp_masked:
            rec['k5_all_masked_rows_exact'] = bool((got5[:, ::2] == 1 / rk.W).all())
        log(f'[k5/k6] {json.dumps(rec)}')
        checks.append(rec)
        if not (rec['k5_within_one_bf16_ulp'] and rec['k6_max_abs_err'] == 0.0
                and rec.get('k5_all_masked_rows_exact', True)):
            raise AssertionError(f'K5 or K6 disagrees with its plain version: {rec}')
        err5, err6 = max(err5, rec['k5_max_abs_err']), max(err6, rec['k6_max_abs_err'])
    rates = vr.card_rates(dev)
    log(f'[k5/k6] card rates: {json.dumps(rates)}')
    usage = rk.mask_chain_resources(dev)
    log(f'[mask_chain] registers, local memory and occupancy (128 threads per block): '
        f'{json.dumps(usage)}')
    if usage['local_bytes']:
        raise AssertionError(f'K5 spills or keeps a stack: {usage}')
    os.makedirs(OUT_DIR, exist_ok=True)
    rows = {}
    for name, fn, plain, err in (
            ('mask_chain', lambda: rk.mask_chain(s, kp, qp, ROOFLINE_K),
             lambda: rk.mask_chain_plain(s, kp, qp, ROOFLINE_K), err5),
            ('muladd_chain', lambda: rk.muladd_chain(s, ROOFLINE_K),
             lambda: rk.muladd_chain_plain(s, ROOFLINE_K), err6)):
        sass = vr.sass_loop(name)
        with open(os.path.join(OUT_DIR, f'{name}.sass'), 'w') as f:
            f.write(sass.pop('sass'))
        rows[name] = dict(K=ROOFLINE_K, elems=s.numel(), max_abs_err=err,
                          ms=time_ms(fn, iters=5, warmup=1),
                          plain_ms=time_ms(plain, iters=3, warmup=1), library_ms=None,
                          **vr.bound(name, ROOFLINE_K, s.numel(), rates), sass=sass)
        rows[name]['share_of_bound'] = rows[name]['bound_ms'] / rows[name]['ms']
        log(f'[{name}] {json.dumps(rows[name])}')
        if 'CALL' in sass['opcodes'] or rows[name]['share_of_bound'] > 1:
            raise AssertionError(f'{name}: a call in its loop, or faster than its bound')
    ops = rows['mask_chain']['sass']['opcodes']
    per_pass = {op: ops.get(op, 0) for op in ('MUFU', 'ISETP', 'FSEL', 'FMNMX', 'F2FP')}
    log(f'[mask_chain] SASS per pass (one lane, {vr.LANE_VALUES["mask_chain"]} values): '
        f'{rows["mask_chain"]["sass"]["instructions_per_pass"]} instructions, '
        f'{rows["mask_chain"]["sass"]["instructions_per_element"]:.3f} per element; '
        f'{json.dumps(per_pass)}')
    rk.LAUNCHES.update(saved)                    # comparison launches do not count

    rk.LAUNCHES.update(mask_chain=0, muladd_chain=0)
    res = vr.roofline(k3_ms=k3_ms, device=dev)
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES)
    log(f'[roofline] {json.dumps(res)}')
    with open(os.path.join(OUT_DIR, 'vpu_roofline.json'), 'w') as f:
        json.dump(res, f, indent=2)
    per_kernel = len(vr.K_PAIR) * (1 + vr.REPEATS)     # warm-up + repeats per K
    if launches != dict(mask_chain=per_kernel, muladd_chain=per_kernel):
        raise AssertionError(f'the roofline tool did not run through K5 and K6: {launches}')
    if not (res['mask_chain_ns_per_pass'] > 0 and res['muladd_ns_per_pass'] > 0
            and 0 < res['mask_chain_share_of_k3'] < 1):
        raise AssertionError(f'the roofline figures are not positive, or the chain\'s '
                             f'share of K3 is not in (0, 1): {res}')
    report.update(roofline_checks=checks, roofline_kernels=rows, roofline=res,
                  roofline_launches=launches, mask_chain_usage=usage)
    return rows, launches


# ------------------------------------------------------- the CLI path (phase 8)
def synthetic_songs(n, n_bar, seed):
    """n seeded step-kind songs, the extractor's records ({'score', 'keys',
    'title'}): 4/4 bars of a melody in quarter notes (a triplet or a rest now
    and then) over a bass in half notes, key scores for three keys.  n_bar
    150 gives ~2,600 tokens: enough to fill 2048."""
    rng = np.random.default_rng(seed)
    toks = list(MusicVocabulary(pitch_kind='step').tok2id)
    octave = lambda t: t.split('/')[-1].split('_')[0]
    high = [t for t in toks if t.startswith('p_') and octave(t) in ('4', '5')]
    low = [t for t in toks if t.startswith('p_') and octave(t) in ('2', '3')]
    keys = [key_ordinal2str[i] for i in range(N_KEY)]
    songs = []
    for i in range(n):
        out = ['TimeSig_4/4', 'Tempo_120']
        for _ in range(n_bar):
            out += ['<bar>', '<melody>']
            for _ in range(4):
                u = rng.random()
                if u < 0.1:
                    out += ['<tup>', *rng.choice(high, 3), 'd_1', '</tup>']
                else:
                    out += ['p_r' if u < 0.2 else str(rng.choice(high)), 'd_1']
            out += ['<bass>', str(rng.choice(low)), 'd_2', str(rng.choice(low)), 'd_2']
        out.append('</s>')
        songs.append(dict(score=' '.join(out), title=f'synthetic-{i}',
                          keys={str(k): float(rng.random())
                                for k in rng.choice(keys, 3, replace=False)}))
    return songs


def run_cli(argv):
    """`cli.main(argv)` on the card -> wall seconds; a non-zero exit raises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f'[cli] {" ".join(argv[:2])} ... exit {rc} in {dt:.1f} s')
    if rc != 0:
        raise AssertionError(f'`{" ".join(argv)}` exited {rc}')
    return dt


class DecodeTimer:
    """Records each `MusicGenerator.generate` call the CLI makes: its prompts,
    raw outputs and card time, so decode tok/s counts the sampled tokens
    before repair."""

    def __init__(self):
        self.calls = []
        self.real = MusicGenerator.generate

    def __enter__(self):
        timer = self

        def generate(gen, prompts, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            texts = timer.real(gen, prompts, **kw)
            torch.cuda.synchronize()
            timer.calls.append((prompts, texts, time.perf_counter() - t0))
            return texts
        MusicGenerator.generate = generate
        return self

    def __exit__(self, *exc):
        MusicGenerator.generate = self.real

    def summary(self, vocab):
        prompts, texts, dt = self.calls[-1]
        for t in texts:
            if any(x not in vocab.tok2id for x in t.split()):
                raise AssertionError(f'a generated token is not in the vocabulary: {t[:200]}')
        new = sum(len(t.split()) - len(p.split()) for p, t in zip(prompts, texts))
        return dict(lengths=[len(t.split()) for t in texts], new_tokens=new, seconds=dt,
                    decode_tok_per_s=new / dt)


def check_rendered(out_dir, n):
    """Every .mxl the generate command wrote parses with the port's io to
    its song's bars (at least one); every .mid parses too, to at least one bar
    when the song sounds a note (a MIDI file of rests holds no track); ->
    (bar counts, share of bar_durations_valid)."""
    sides = sorted(f for f in os.listdir(out_dir) if f.endswith('.json'))
    if len(sides) != n:
        raise AssertionError(f'{out_dir}: {len(sides)} songs written, expected {n}')
    bars, valid = [], []
    for side in sides:
        stem = os.path.join(out_dir, side[:-len('.json')])
        with open(stem + '.json') as f:
            rec = json.load(f)
        n_bar = rec['text'].split().count('<bar>')
        n_mxl = len(parse_file(stem + '.mxl').parts[0].measures)
        n_mid = max((len(part.measures) for part in read_midi(stem + '.mid').parts), default=0)
        sounds = any(x.startswith('p_') and x != 'p_r' for x in rec['text'].split())
        if n_mxl != n_bar or n_bar < 1 or (sounds and n_mid < 1) or n_mid > n_bar:
            raise AssertionError(f'{stem}: {n_bar} bars written, {n_mxl} read from the MXL, '
                                 f'{n_mid} from the MIDI')
        bars.append(dict(mxl=n_mxl, midi=n_mid, tokens=len(rec['text'].split())))
        valid.append(bool(rec['bar_durations_valid']))
    return bars, sum(valid) / len(valid)


def render_songs(songs, out_dir):
    """Each song rendered by the port's converter to a file a user would
    extract: the even ones as .mxl, the odd ones as .mid -> the paths."""
    os.makedirs(out_dir)
    mc, paths = MusicConverter(mode='full'), []
    for i, song in enumerate(songs):
        score = mc.str2score(song['score'], pitch_kind='step', title=song['title'])
        path = os.path.join(out_dir, f'{song["title"]}.{"mid" if i % 2 else "mxl"}')
        (score.write_midi if i % 2 else score.write_mxl)(path)
        paths.append(path)
    return paths


def extraction_checks(mid_paths):
    """The port's extractors on this machine: `MusicExtractor` (full, melody)
    on the golden MusicXML files and `FastMidiExtractor` (full) on the golden
    MIDI files equal the frozen tests/goldens/extraction.json byte for byte;
    then the Python and native extractors' songs per second on `mid_paths`
    (host work, one process)."""
    with open(os.path.join(GOLDEN_DIR, 'extraction.json')) as f:
        frozen = json.load(f)
    fast = FastMidiExtractor(mode='full')
    for name, want in sorted(frozen.items()):
        score = parse_file(os.path.join(GOLDEN_DIR, f'{name}.musicxml'))
        got = {mode: MusicExtractor(mode=mode, warn_logger=True)(score, exp='str_join')
               for mode in ('full', 'melody')}
        got['fast_full'] = fast(os.path.join(GOLDEN_DIR, f'{name}.mid'))
        for key, text in got.items():
            if text != want[key]:
                raise AssertionError(f'{name} {key}: the extraction differs from the frozen '
                                     f'golden: {text[:200]}')
    rates = {}
    for label, extract in (
            ('python', lambda p: MusicExtractor(mode='full', with_pitch_step=True)(
                p, exp='str_join', return_meta=True, return_key=True)),
            ('native', fast.extract_with_meta)):
        t0 = time.perf_counter()
        for p in mid_paths:
            extract(p)
        dt = time.perf_counter() - t0
        rates[label] = dict(songs=len(mid_paths), seconds=dt, songs_per_s=len(mid_paths) / dt)
    log(f'[extract] goldens equal tests/goldens/extraction.json ({len(frozen)} songs: full, '
        f'melody, fast_full); on {len(mid_paths)} rendered .mid files: python '
        f'{rates["python"]["songs_per_s"]:.2f} songs/s, native '
        f'{rates["native"]["songs_per_s"]:.2f} songs/s')
    return dict(goldens=len(frozen), **rates)


def state_bytes(model, rows):
    """Bytes of the per-row fields (batch on axis 1) of a decode state of
    `rows` rows: what a reorder gathers for that many rows."""
    state = model.init_decode_state(rows)
    n = sum(x.numel() * x.element_size() for x in state
            if isinstance(x, torch.Tensor) and x.ndim > 1 and x.shape[1] == rows)
    del state
    return n


def search_commands(run, root, family, vocab, commands):
    """`generate` with each strategy's flags (2 songs, SEARCH_LEN tokens):
    wall seconds, decode tok/s of the sampled tokens, peak device memory and
    the files re-read; no K1-K4 launch -> {label: record}."""
    out = {}
    for label, flags in commands:
        gen_dir = os.path.join(root, f'search-{family}-{label}')
        torch.cuda.reset_peak_memory_stats()
        with DecodeTimer() as timer:
            wall = run_cli(['generate', '--model-dir', run, '--out', gen_dir, '--n', '2',
                            '--max-length', str(SEARCH_LEN), *flags])
            dec = timer.summary(vocab)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        bars, valid = check_rendered(gen_dir, 2)
        for side in (f for f in os.listdir(gen_dir) if f.endswith('.json')):
            with open(os.path.join(gen_dir, side)) as f:
                if json.load(f)['strategy'] != flags[1]:
                    raise AssertionError(f'{gen_dir}/{side}: not a {flags[1]} run')
        out[label] = dict(flags=flags, wall_s=wall, peak_gib=peak, bars=bars,
                          bar_durations_valid_share=valid, **dec)
        log(f'[search] {family} {label}: wall {wall:.1f} s, decode {dec["seconds"]:.1f} s, '
            f'{dec["decode_tok_per_s"]:.1f} tok/s, lengths {dec["lengths"]}, peak '
            f'{peak:.2f} GiB, re-read bars {[b["mxl"] for b in bars]}')
    return out


def exact_search_checks(run, dev, key):
    """On the trained model: two beam calls with the same arguments give the
    same tokens; contrastive search with one candidate and no penalty gives
    the greedy tokens (EXACT_LEN tokens, two prompts); and the bytes a search
    step moves besides the decode: the beam reorder's gather of 8 rows (read
    and written) and contrastive search's expanded copy (2 rows read, 8
    written) and its context hiddens."""
    model, params, tok = load_trained(run, device=dev)
    gen = MusicGenerator(model, tok, params, augment_key=key is not None)
    prompts = [gen.unconditional_prompt(key=key),
               gen.unconditional_prompt(time_sig=(3, 4), tempo=90, key=key)]
    t0 = time.perf_counter()
    beams = [gen.generate(prompts, strategy='beam', max_length=EXACT_LEN, num_beams=4)
             for _ in range(2)]
    if beams[0] != beams[1]:
        raise AssertionError(f'two beam calls differ: {beams}')
    greedy = gen.generate(prompts, strategy='greedy', max_length=EXACT_LEN)
    contrastive = gen.generate(prompts, strategy='contrastive', max_length=EXACT_LEN, top_k=1,
                               penalty_alpha=0.0)
    if contrastive != greedy:
        raise AssertionError(f'contrastive (1, 0) is not greedy: {contrastive} {greedy}')
    d = getattr(model, 'hidden_dim', model.cfg.d_model)
    rec = dict(seconds=time.perf_counter() - t0, beam_repeat_equal=True,
               contrastive_1_0_is_greedy=True,
               beam_reorder_bytes_per_step=2 * state_bytes(model, 8),
               contrastive_expand_bytes_per_step=state_bytes(model, 2) + state_bytes(model, 8),
               state_bytes_per_row=state_bytes(model, 1),
               contrastive_ctx_h_bytes=2 * SEARCH_LEN * d * model.cfg.compute_dtype.itemsize)
    del model, params, gen
    torch.cuda.empty_cache()
    return rec


def pipeline_profile(recipe, ds_dir, dev):
    """Device-busy share of the recipe's own input pipeline (AugmentedDataset
    batches through `prefetch`, to the card) feeding training steps: one
    epoch of `setup_recipe`'s Trainer on the dataset, eval and checkpoints
    left out."""
    trainer = tr.setup_recipe(recipe, SongDataset.load(os.path.join(ds_dir, 'train.npz')),
                              out_dir=os.path.join(RUN_DIR, 'profile'), device=dev)
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    for t in flatten(params).values():
        t.requires_grad_(True)
    state = trainer.opt.init(params)
    B = trainer.args.batch_size

    def epoch():
        for batch in prefetch(trainer.train_dataset.batches(B, shuffle=True, seed=SEED)):
            trainer.train_step(params, state, tr._to_device(batch, dev))
    prof = profile(epoch)
    steps = len(trainer.train_dataset) // B
    del trainer, params, state
    torch.cuda.empty_cache()
    return dict(steps=steps, **{k: prof[k] for k in ('wall_ms', 'device_ms', 'busy_share',
                                                     'n_kernels')}, top=prof['top'][:6])


def cli_path(dev, report):
    """Phase 8: raw .mxl / .mid files -> extract -> dataset -> train --recipe
    22-11 -> generate (unconditional and conditional) -> re-read -> beam,
    diverse-beam and contrastive search; train --recipe 22-04 -> generate ->
    beam and contrastive search; counted."""
    root = os.path.join(RUN_DIR, 'cli')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    combined, ds = os.path.join(root, 'combined.json'), os.path.join(root, 'dataset')
    songs = synthetic_songs(64, 150, SEED + 30)
    rec = dict(walls={}, added_seconds={})
    t0 = time.perf_counter()
    files = render_songs(songs, os.path.join(root, 'raw'))
    rec['added_seconds']['render'] = time.perf_counter() - t0
    # extraction in 4 worker processes, spawned from this process, which holds the card
    rec['walls']['extract'] = run_cli(['extract', *files, '--out', os.path.join(root, 'json'),
                                       '--jobs', '4', '--combine', combined])
    rec['added_seconds']['extract'] = rec['walls']['extract']
    with open(combined) as f:
        extracted = json.load(f)
    lens = [len(x['score'].split()) for x in extracted['music']]
    rec['extract'] = dict(songs=extracted['n_song'], songs_per_s=len(files) / rec['walls']['extract'],
                          tokens_min=min(lens), tokens_max=max(lens))
    log(f'[cli] extract: {extracted["n_song"]} of {len(files)} songs (32 .mxl + 32 .mid) in '
        f'{rec["walls"]["extract"]:.2f} s, {rec["extract"]["songs_per_s"]:.2f} songs/s, '
        f'{min(lens)}-{max(lens)} tokens each')
    if extracted['n_song'] != len(files) or min(lens) <= 2048:
        raise AssertionError(f'extract: {extracted["n_song"]} songs of {len(files)} (an error '
                             f'writes no song), shortest {min(lens)} tokens')
    t0 = time.perf_counter()
    rec['extraction'] = extraction_checks([p for p in files if p.endswith('.mid')])
    rec['added_seconds']['extraction checks'] = time.perf_counter() - t0
    rec['walls']['dataset'] = run_cli(['dataset', combined, '--out', ds, '--pitch-kind', 'step',
                                       '--test-frac', '0.1'])
    with open(os.path.join(ds, 'meta.json')) as f:
        meta = json.load(f)
    if (meta['n_train'], meta['n_test']) != (58, 6):
        raise AssertionError(f'dataset split: {meta}')

    # 22-11: TF-XL base, degree vocab 1190, 1024 / mem 512, batch 21
    run = os.path.join(root, '22-11')
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    rec['walls']['train 22-11'] = run_cli(['train', '--dataset', ds, '--out', run, '--recipe',
                                           '22-11', '--epochs', '1'])
    launches_1122 = dict(fa.LAUNCHES)
    log_ = step_log(run)
    steps = [r for r in log_ if 'loss' in r]
    ep = [r for r in log_ if 'train_tokens_per_sec' in r][0]
    n_layer = base_config().n_layer
    n_steps, n_eval = 58 // 21, 1
    log(f'[cli] train 22-11: losses {[round(r["loss"], 4) for r in steps]}, epoch '
        f'{ep["train_tokens_per_sec"]:.0f} non-pad tok/s, eval loss {ep["eval_loss"]:.4f} '
        f'ikr {ep["eval_ikr"]:.4f}; launches {launches_1122}')
    if len(steps) != n_steps or not all(math.isfinite(r['loss']) for r in steps) or \
            launches_1122 != dict(flash_rel_attn_fwd=n_layer * (n_steps + n_eval),
                                  flash_rel_attn_bwd=n_layer * n_steps):
        raise AssertionError(f'the 22-11 CLI run: {steps} {launches_1122}')
    if not os.path.exists(os.path.join(run, 'trained.npz')):
        raise AssertionError('the 22-11 CLI run wrote no trained.npz')
    rec['train_22_11'] = dict(steps=steps, epoch=ep, launches=launches_1122)

    gen_dir = os.path.join(root, 'gen-22-11')
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    dtok = MusicTokenizer(pitch_kind='degree')
    with DecodeTimer() as timer:
        rec['walls']['generate 22-11'] = run_cli([
            'generate', '--model-dir', run, '--out', gen_dir, '--n', '4', '--key', 'CMajor',
            '--top-k', '8', '--max-length', '1024', '--seed', str(SEED)])
        rec['generate_22_11'] = timer.summary(dtok.vocab)
        # a prompt from a rendered song: 8 bars of a training song as an
        # extracted MXL, its key from KeyFinder, the first 4 bars via mxl2str
        toks = songs[0]['score'].split()
        ninth_bar = [i for i, x in enumerate(toks) if x == '<bar>'][8]
        text = ' '.join(toks[:ninth_bar] + ['</s>'])
        prompt_mxl = os.path.join(root, 'prompt.mxl')
        MusicConverter(mode='full').str2score(text, pitch_kind='step',
                                              title='prompt').write_mxl(prompt_mxl)
        keys = KeyFinder(parse_file(prompt_mxl))(return_type='dict')
        key = max(keys, key=keys.get)
        cond_dir = os.path.join(root, 'gen-22-11-cond')
        rec['walls']['generate 22-11 conditional'] = run_cli([
            'generate', '--model-dir', run, '--out', cond_dir, '--n', '1', '--key', key,
            '--condition-on', prompt_mxl, '--n-bar', '4', '--top-k', '8', '--max-length',
            '1024', '--seed', str(SEED)])
        rec['generate_22_11_conditional'] = dict(key=key, **timer.summary(dtok.vocab))
    # phase 4's request (seeded weights, 4 keys, top_k 8) in this process
    # state: the CLI's decode is held against it as well as against phase 4
    model = TransfoXL(base_config())
    _, lens, new_tok, dt = run_generation(model, params_from_jax(model.init_flat(SEED), dev),
                                          dtok, 4, 'sample', SEED, top_k=8)
    rec['generate_22_11_seeded_after_cli'] = dict(lengths=lens, new_tokens=new_tok, seconds=dt,
                                                  decode_tok_per_s=new_tok / dt)
    del model
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f'generation runs the plain decode step, no kernel: {fa.LAUNCHES}')
    (prompt,), _, _ = timer.calls[-1]
    if prompt.split()[2] != f'Key_{key}' or prompt.split().count('<bar>') != 4:
        raise AssertionError(f'the conditional prompt is not 4 bars in {key}: {prompt}')
    bars, valid = check_rendered(gen_dir, 4)
    cbars, cvalid = check_rendered(cond_dir, 1)
    rec['rendered_22_11'] = dict(bars=bars, bar_durations_valid_share=valid,
                                 conditional_bars=cbars, conditional_valid=cvalid)
    log(f'[cli] generate 22-11: {json.dumps(rec["generate_22_11"])}; conditional on {key}: '
        f'{json.dumps(rec["generate_22_11_conditional"])}; phase 4\'s request after them: '
        f'{json.dumps(rec["generate_22_11_seeded_after_cli"])}; re-read bars {bars} + {cbars}, '
        f'bar_durations_valid {valid:.2f} / {cvalid:.2f}')
    rec['profile_22_11'] = pipeline_profile('22-11', ds, dev)
    log(f'[cli] 22-11 input pipeline + steps: {json.dumps(rec["profile_22_11"])}')
    # beam, diverse-beam and contrastive search on the trained 22-11 model:
    # decode only, no K1 / K2 launch
    t0 = time.perf_counter()
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    key = ['--key', 'CMajor']
    rec['search_22_11'] = search_commands(run, root, '22-11', dtok.vocab, [
        ('beam', ['--strategy', 'beam', '--num-beams', '4', *key]),
        ('diverse-beam', ['--strategy', 'beam', '--num-beams', '4', '--num-beam-groups', '2',
                          '--diversity-penalty', '1.0', *key]),
        ('contrastive', ['--strategy', 'contrastive', '--top-k', '4', '--penalty-alpha', '0.6',
                         *key])])
    rec['exact_22_11'] = exact_search_checks(run, dev, 'CMajor')
    log(f'[search] 22-11 exact checks: {json.dumps(rec["exact_22_11"])}')
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f'search runs the plain decode step, no kernel: {fa.LAUNCHES}')
    rec['added_seconds']['search 22-11'] = time.perf_counter() - t0
    shutil.rmtree(run)

    # 22-04: Reformer base, midi vocab 422, 2048, batch 32
    run = os.path.join(root, '22-04')
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    rec['walls']['train 22-04'] = run_cli(['train', '--dataset', ds, '--out', run, '--recipe',
                                           '22-04', '--epochs', '1'])
    launches_2204 = dict(ck.LAUNCHES)
    log_ = step_log(run)
    steps = [r for r in log_ if 'loss' in r]
    ep = [r for r in log_ if 'train_tokens_per_sec' in r][0]
    n_layer = len(reformer_config().attn_layers)
    n_steps = 58 // 32
    log(f'[cli] train 22-04: losses {[round(r["loss"], 4) for r in steps]}, epoch '
        f'{ep["train_tokens_per_sec"]:.0f} non-pad tok/s, eval loss {ep["eval_loss"]:.4f}; '
        f'launches {launches_2204}')
    if len(steps) != n_steps or not all(math.isfinite(r['loss']) for r in steps) or \
            launches_2204 != dict(chunked_window_attn_fwd=n_layer * (n_steps + n_eval),
                                  chunked_window_attn_bwd=n_layer * n_steps):
        raise AssertionError(f'the 22-04 CLI run: {steps} {launches_2204}')
    rec['train_22_04'] = dict(steps=steps, epoch=ep, launches=launches_2204)
    gen_dir = os.path.join(root, 'gen-22-04')
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    with DecodeTimer() as timer:
        rec['walls']['generate 22-04'] = run_cli([
            'generate', '--model-dir', run, '--out', gen_dir, '--n', '4', '--top-p', '0.9',
            '--max-length', str(GEN_LEN), '--seed', str(SEED)])
        rec['generate_22_04'] = timer.summary(MusicTokenizer(pitch_kind='midi').vocab)
    if any(ck.LAUNCHES.values()):
        raise AssertionError(f'Reformer decode runs no kernel: {ck.LAUNCHES}')
    bars, valid = check_rendered(gen_dir, 4)
    rec['rendered_22_04'] = dict(bars=bars, bar_durations_valid_share=valid)
    log(f'[cli] generate 22-04: {json.dumps(rec["generate_22_04"])}; re-read bars {bars}, '
        f'bar_durations_valid {valid:.2f}')
    # beam and contrastive search on the trained 22-04 model, at SEARCH_LEN
    # (half its 2048, to bound the phase's time): no K3 / K4 launch
    t0 = time.perf_counter()
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    rec['search_22_04'] = search_commands(run, root, '22-04',
                                          MusicTokenizer(pitch_kind='midi').vocab, [
        ('beam', ['--strategy', 'beam', '--num-beams', '4']),
        ('contrastive', ['--strategy', 'contrastive', '--top-k', '4', '--penalty-alpha', '0.6'])])
    rec['exact_22_04'] = exact_search_checks(run, dev, None)
    log(f'[search] 22-04 exact checks: {json.dumps(rec["exact_22_04"])}')
    if any(ck.LAUNCHES.values()):
        raise AssertionError(f'Reformer search runs no kernel: {ck.LAUNCHES}')
    rec['added_seconds']['search 22-04'] = time.perf_counter() - t0
    rec['profile_22_04'] = pipeline_profile('22-04', ds, dev)
    log(f'[cli] 22-04 input pipeline + steps: {json.dumps(rec["profile_22_04"])}')
    log(f'[cli] wall seconds per command: {json.dumps(rec["walls"])}')
    log(f'[cli] seconds of the raw-file, extraction and search parts: '
        f'{json.dumps(rec["added_seconds"])}, total {sum(rec["added_seconds"].values()):.1f} s')
    report['cli'] = rec
    return launches_1122, launches_2204


# -------------------------------------- A.6 and the learned tokenizers (phase 9)
def rel_max(a, b) -> float:
    """Largest error of a against b over b's largest entry."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def dispatch_checks(dev, report):
    """Phase 9.1, A.6: a forward with an attention mask and a training step
    with dropatt > 0 run every layer through the plain rel_attn (no K1 / K2
    launch); without either, K1 runs once per layer; the masked forward in
    f32 on the card against the port's CPU run."""
    cfg = base_config()
    model = TransfoXL(cfg)
    flat = model.init_flat(SEED)
    params = params_from_jax(flat, dev)
    ids, labels = score_inputs(cfg.vocab_size, 8, 1024, SEED + 40, dev)
    B, T = ids.shape
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    for b in range(B):                            # padded tails: 1024, 922, ..., 308 real
        mask[b, T - b * T // 10:] = False
    labels[~mask] = -100
    rec = {}
    with torch.no_grad():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
        logits, _, _ = model.forward(params, ids, attn_mask=mask)
        torch.cuda.synchronize()
        rec['masked_forward'] = dict(launches=dict(fa.LAUNCHES),
                                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                                     ms=time_ms(lambda: model.forward(params, ids, attn_mask=mask),
                                                iters=2, warmup=0))
        if any(rec['masked_forward']['launches'].values()) or not torch.isfinite(logits).all():
            raise AssertionError(f'the masked forward: {rec["masked_forward"]}')
        fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
        model.forward(params, ids)
        torch.cuda.synchronize()
        rec['unmasked_forward_launches'] = dict(fa.LAUNCHES)
        if rec['unmasked_forward_launches'] != dict(flash_rel_attn_fwd=cfg.n_layer,
                                                   flash_rel_attn_bwd=0):
            raise AssertionError(f'dropatt 0, no mask: {rec["unmasked_forward_launches"]}')
        del logits
    # a training step with attention dropout, B 4 (rel_attn keeps its f32
    # scores, probabilities and dropout mask of every layer for the backward)
    drop = TransfoXL(base_config(dropatt=0.1, dropout=0.1))
    leaves = flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    loss, _ = drop.loss(params, ids[:4], labels[:4], generator=gen, deterministic=False)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    rec['dropatt_step'] = dict(loss=float(loss.detach()), launches=dict(fa.LAUNCHES),
                               seconds=time.perf_counter() - t0,
                               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    for t in leaves.values():
        t.requires_grad_(False)
    if any(fa.LAUNCHES.values()) or not math.isfinite(float(loss.detach())) or \
            not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError(f'the dropatt 0.1 step: {rec["dropatt_step"]}')
    del grads, loss, params
    torch.cuda.empty_cache()
    # the masked forward in f32 at B 1, card against CPU
    cfg32 = base_config(dtype='float32')
    with torch.no_grad():
        card, _, _ = TransfoXL(cfg32).forward(params_from_jax(flat, dev), ids[-2:-1],
                                              attn_mask=mask[-2:-1])
        cpu, _, _ = TransfoXL(cfg32, device='cpu').forward(
            params_from_jax(flat, 'cpu'), ids[-2:-1].cpu(), attn_mask=mask[-2:-1].cpu())
    rec['masked_f32_card_vs_cpu'] = rel_max(card, cpu)
    log(f'[dispatch] {json.dumps(rec)}')
    if not rec['masked_f32_card_vs_cpu'] <= TOL_F32_LOGITS:
        raise AssertionError(f'masked f32 logits, card vs CPU: {rec["masked_f32_card_vs_cpu"]}')
    report['dispatch'] = rec
    torch.cuda.empty_cache()


def large_head_checks(dev, ds, report):
    """Phase 9.2: TF-XL base over the 262,144-unit table, bf16, 8 x 1024.
    The tiled CE (head_chunk 16384) against the dense CE on the same
    parameters and batch (dropout 0): loss, preds where the top two logits
    are apart by more than a bf16 rounding, the embedding gradient, each
    one's step time and peak memory.  Then `Trainer.train` for one epoch
    with `WordPieceMusicTokenizer.from_file` and `StringAugmentedDataset`
    over phase 8's songs (key insertion, pitch shift): launches, step time,
    tokens/s, peak memory, the device-busy share of the host pipeline that
    feeds steps, and the head's share of a step's device time."""
    V = 262144
    tiled, dense = TransfoXL(base_config(vocab_size=V, head_chunk=HEAD_CHUNK)), \
        TransfoXL(base_config(vocab_size=V))
    params = params_from_jax(tiled.init_flat(SEED), dev)
    leaves = flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    ids, labels = score_inputs(V, 8, 1024, SEED + 41, dev)
    labels[-3:, -124:] = -100

    def step(model):
        loss, mets = model.loss(params, ids, labels)
        return loss, mets, torch.autograd.grad(loss, list(leaves.values()))
    rec, out = {}, {}
    for name, model in (('tiled', tiled), ('dense', dense)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
        loss, mets, grads = step(model)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = (float(loss.detach()), mets['preds'], grads[list(leaves).index('embed/weight')])
        del loss, mets, grads
        rec[name] = dict(loss=out[name][0], peak_gib=peak, launches=launches,
                         ms=time_ms(lambda: step(model), iters=2, warmup=0))
        log(f'[head] {name} CE, V {V}, 8x1024 bf16: {json.dumps(rec[name])}')
    with torch.no_grad():
        logits, _, _ = dense.forward(params, ids)
        top2 = logits[:, :-1].topk(2, dim=-1).values
        del logits
    apart = (top2[..., 0] - top2[..., 1]) > 2 ** -8 * top2[..., 0].abs()
    same = out['tiled'][1][:, :-1][apart] == out['dense'][1][:, :-1][apart]
    rec['compare'] = dict(
        loss_rel=abs(out['tiled'][0] - out['dense'][0]) / abs(out['dense'][0]),
        preds_compared=int(apart.sum()), preds_positions=int(apart.numel()),
        preds_equal=bool(same.all()), embed_grad_rel=rel_max(out['tiled'][2], out['dense'][2]),
        tol=TOL_HEAD)
    log(f'[head] tiled vs dense: {json.dumps(rec["compare"])}')
    n_layer = tiled.cfg.n_layer
    if rec['tiled']['launches'] != dict(flash_rel_attn_fwd=n_layer, flash_rel_attn_bwd=n_layer) \
            or not rec['compare']['loss_rel'] <= TOL_HEAD['loss'] \
            or not rec['compare']['preds_equal'] \
            or not rec['compare']['embed_grad_rel'] <= TOL_HEAD['embed_grad']:
        raise AssertionError(f'the tiled CE against the dense CE: {rec}')
    del out, top2, apart, same
    torch.cuda.empty_cache()

    # one epoch of the 262k tier through the Trainer and the string pipeline
    tok = WordPieceMusicTokenizer.from_file(TABLE_262K, model_max_length=1024)
    aug = dict(insert_key=True, pitch_shift=True)
    train = StringAugmentedDataset(songdataset_to_dicts(
        SongDataset.load(os.path.join(ds, 'train.npz'))), tok, dataset_split='train', **aug)
    evald = StringAugmentedDataset(songdataset_to_dicts(
        SongDataset.load(os.path.join(ds, 'test.npz'))), tok, random_crop=False,
        dataset_split='test', **aug)
    B = 8
    run = os.path.join(RUN_DIR, 'wordpiece-262k')
    trainer = tr.Trainer(TransfoXL(base_config(vocab_size=V, head_chunk=HEAD_CHUNK, dropout=0.1)),
                         tok, train, evald, out_dir=run, ikr_mode='ins-key',
                         args=train_args(batch_size=B, num_train_epochs=1, save_per_epoch=False,
                                         seed=SEED))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    t0 = time.perf_counter()
    trainer.train(params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    log_ = step_log(run)
    steps = [r for r in log_ if 'loss' in r]
    ep = [r for r in log_ if 'train_tokens_per_sec' in r][0]
    n_steps, n_eval = len(train) // B, -(-len(evald) // B)
    rec['epoch'] = dict(steps=len(steps), wall_s=wall, launches=launches,
                        losses=[r['loss'] for r in steps], epoch=ep,
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f'[head] Trainer epoch, WordPiece 262k, tiled CE: {json.dumps(rec["epoch"])}')
    if len(steps) != n_steps or n_steps < 3 or \
            not all(math.isfinite(r['loss']) for r in steps) or \
            launches != dict(flash_rel_attn_fwd=n_layer * (n_steps + n_eval),
                             flash_rel_attn_bwd=n_layer * n_steps):
        raise AssertionError(f'the 262k epoch: {rec["epoch"]}')

    # a bare step on a batch already on the card; the head's share of its
    # device time; the host pipeline (string transforms, WordPiece encoding)
    # feeding steps
    state = trainer.opt.init(params)
    batch = tr._to_device(next(train.batches(B, shuffle=True, seed=1)), dev)
    step_fn = lambda: trainer.train_step(params, state, batch)
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(step_fn, iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof_step = profile(step_fn)
    with torch.no_grad():
        h, _, _ = trainer.model.forward_hidden(params, batch['input_ids'])
    head_in = [h.detach().requires_grad_(True),
               params['embed']['weight'].detach().to(h.dtype).requires_grad_(True),
               params['out_bias'].detach().requires_grad_(True)]
    prof_head = profile(lambda: torch.autograd.grad(chunked_shifted_ce_loss(
        head_in[0], batch['labels'], head_in[1], head_in[2], chunk=HEAD_CHUNK)[0], head_in))

    def epoch():
        for b in prefetch(train.batches(B, shuffle=True, seed=SEED)):
            trainer.train_step(params, state, tr._to_device(b, dev))
    prof_pipe = profile(epoch)
    n_tok = int((batch['labels'] != -100).sum())
    rec['step'] = dict(ms=ms, tok_per_s=B * 1024 / ms * 1e3, nonpad_tok_per_s=n_tok / ms * 1e3,
                       peak_gib=peak, device_ms=prof_step['device_ms'],
                       busy_share=prof_step['busy_share'], head_device_ms=prof_head['device_ms'],
                       head_share=prof_head['device_ms'] / prof_step['device_ms'],
                       head_flops_fwd=2 * B * 1023 * 768 * V, top=prof_step['top'][:6])
    rec['pipeline'] = {k: prof_pipe[k] for k in ('wall_ms', 'device_ms', 'busy_share',
                                                 'n_kernels')}
    rec['pipeline']['steps'] = n_steps
    log(f'[head] 262k step: {json.dumps(rec["step"])}; pipeline + steps: '
        f'{json.dumps(rec["pipeline"])}')
    report['large_head'] = rec
    del trainer, params, state, batch, h, head_in
    torch.cuda.empty_cache()


def learned_cli_path(dev, root, report):
    """Phase 9.3: the learned schemes through the command line, as the JAX
    CLI has them (dense head): `train --tokenizer-scheme wordpiece` over the
    shipped 262k table, TF-XL base, 1024, batch 4, one epoch, then
    `generate` at max_length 512; the same with a pair-merge table trained
    here on phase 8's songs; every written file re-read."""
    ds = os.path.join(root, 'dataset')
    songs = songdataset_to_dicts(SongDataset.load(os.path.join(ds, 'train.npz')))
    t0 = time.perf_counter()
    pm_table = os.path.join(root, 'pairmerge.json')
    pm = PairMergeTokenizerTrainer(pitch_kind='degree')(
        list(WordPieceMusicTrainer.key_augmented_corpus(songs)), coverage_ratio=0.95,
        save=pm_table)
    rec = dict(pairmerge_table=dict(seconds=time.perf_counter() - t0, vocab_size=pm.vocab_size),
               walls={})
    base = ['--model', 'transf-xl', '--size', 'base', '--max-length', '1024', '--batch-size',
            '4', '--epochs', '1']
    n_layer, n_steps, n_eval = 12, 58 // 4, -(-6 // 4)
    for scheme, table in (('wordpiece', TABLE_262K), ('pairmerge', pm_table)):
        run = os.path.join(root, f'learned-{scheme}')
        fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
        rec['walls'][f'train {scheme}'] = run_cli(['train', '--dataset', ds, '--out', run,
                                                   '--tokenizer-scheme', scheme,
                                                   '--tokenizer-path', table, *base])
        launches = dict(fa.LAUNCHES)
        log_ = step_log(run)
        steps = [r for r in log_ if 'loss' in r]
        ep = [r for r in log_ if 'train_tokens_per_sec' in r][0]
        with open(os.path.join(run, 'meta.json')) as f:
            meta = json.load(f)
        rec[scheme] = dict(launches=launches, steps=len(steps), epoch=ep,
                           vocab_size=meta['config']['vocab_size'],
                           losses=[r['loss'] for r in steps])
        if len(steps) != n_steps or not all(math.isfinite(r['loss']) for r in steps) or \
                meta['tokenizer']['scheme'] != scheme or \
                launches != dict(flash_rel_attn_fwd=n_layer * (n_steps + n_eval),
                                 flash_rel_attn_bwd=n_layer * n_steps):
            raise AssertionError(f'train --tokenizer-scheme {scheme}: {rec[scheme]}')
        gen_dir = os.path.join(root, f'gen-{scheme}')
        with DecodeTimer() as timer:
            rec['walls'][f'generate {scheme}'] = run_cli([
                'generate', '--model-dir', run, '--out', gen_dir, '--n', '2', '--key', 'CMajor',
                '--max-length', '512', '--seed', str(SEED)])
            rec[scheme]['generate'] = timer.summary(MusicVocabulary(pitch_kind='degree'))
        bars, valid = check_rendered(gen_dir, 2)
        rec[scheme]['rendered'] = dict(bars=bars, bar_durations_valid_share=valid)
        log(f'[learned] {scheme}: {json.dumps(rec[scheme])}')
        shutil.rmtree(run)
    log(f'[learned] wall seconds per command: {json.dumps(rec["walls"])}')
    report['learned_cli'] = rec


def adaptive_checks(dev, report):
    """Phase 9.4: TF-XL base over the degree vocab with the adaptive head
    (cutoffs (1000,), cluster parameters drawn with numpy): f32 log-probs
    at B 1 on the card against the port's CPU run, their logsumexp, K1 once
    per layer; 64 greedy decode steps through the adaptive head in bf16 with
    no kernel launch."""
    cfg = base_config(adaptive_cutoffs=(1000,))
    flat = TransfoXL(cfg).init_flat(SEED)
    rng = np.random.default_rng(SEED + 42)
    flat['adaptive/cluster_w'] = rng.standard_normal((1, cfg.d_model), dtype=np.float32) * 0.02
    flat['adaptive/cluster_b'] = rng.standard_normal(1).astype(np.float32)
    ids, _ = score_inputs(cfg.vocab_size, 1, 1024, SEED + 43, dev)
    cfg32 = dataclasses.replace(cfg, dtype='float32')
    rec = {}
    with torch.no_grad():
        fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
        card, _, _ = TransfoXL(cfg32).forward(params_from_jax(flat, dev), ids)
        torch.cuda.synchronize()
        rec['f32_launches'] = dict(fa.LAUNCHES)
        cpu, _, _ = TransfoXL(cfg32, device='cpu').forward(params_from_jax(flat, 'cpu'),
                                                          ids.cpu())
        rec['f32_card_vs_cpu'] = rel_max(card, cpu)
        rec['f32_lse_max'] = float(torch.logsumexp(card, -1).abs().max())
        model = TransfoXL(cfg)
        dparams = model.compute_params(params_from_jax(flat, dev))
        state = model.init_decode_state(4)
        tok = torch.from_numpy(np.array([1, 2, 3, 4])).to(dev)
        fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
        lse = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(64):
            lp, state = model.decode_step(dparams, tok, state)
            lse.append(torch.logsumexp(lp, -1).abs().max())
            tok = lp.argmax(-1)
        torch.cuda.synchronize()
        rec['decode'] = dict(steps=64, ms_per_step=(time.perf_counter() - t0) / 64 * 1e3,
                             launches=dict(fa.LAUNCHES),
                             lse_max=float(torch.stack(lse).max()))
    log(f'[adaptive] {json.dumps(rec)}')
    if rec['f32_launches'] != dict(flash_rel_attn_fwd=cfg.n_layer, flash_rel_attn_bwd=0) or \
            not rec['f32_card_vs_cpu'] <= TOL_F32_LOGITS or \
            not rec['f32_lse_max'] <= TOL_LSE or any(rec['decode']['launches'].values()) or \
            not rec['decode']['lse_max'] <= TOL_LSE:
        raise AssertionError(f'the adaptive head: {rec}')
    report['adaptive'] = rec
    del model, dparams, state
    torch.cuda.empty_cache()


def learned_tokenizer_phase(dev, report):
    """Phase 9 on phase 8's dataset directory, each part counted."""
    t0 = time.perf_counter()
    seconds = {}
    root = os.path.join(RUN_DIR, 'cli')
    for name, fn in (('dispatch', lambda: dispatch_checks(dev, report)),
                     ('large head', lambda: large_head_checks(dev, os.path.join(root, 'dataset'),
                                                              report)),
                     ('learned CLI', lambda: learned_cli_path(dev, root, report)),
                     ('adaptive', lambda: adaptive_checks(dev, report))):
        t1 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t1
    report['phase9_seconds'] = dict(seconds, total=time.perf_counter() - t0)
    log(f'[phase 9] seconds: {json.dumps(report["phase9_seconds"])}')


# ------------------------------------ HF interop and the models' knobs (phase 10)
def normal(rng, *shape, std=0.02):
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)


SCAN_CHUNK = 512          # the streamed LSH scan's chunk (decode_scan_chunk), phase 10
GREEDY_LEN = 128          # greedy tokens per decode estimator, phase 10
CONTRASTIVE_LEN = 256     # the contrastive search's length over the [2 d] hidden, phase 10
# HF config objects, by HF's attribute names: TF-XL at the 22-11 widths (the
# reference's cutoffs [1000] for vocab >= 1000; HF's defaults same_length and
# untie_r) and the Reformer at the 22-04 widths (relu, layer_norm_eps 1e-12,
# axial (32, 64) x (192, 576), chunks of 64 in HF's causal one-look-back layout)
HF_TFXL = dict(vocab_size=1190, d_model=768, d_embed=768, n_head=12, d_head=64, d_inner=3072,
               n_layer=12, mem_len=512, clamp_len=1024, cutoffs=[1000], div_val=1,
               same_length=True, untie_r=True, dropout=0.1, pre_lnorm=False)
HF_REFORMER = dict(vocab_size=422, hidden_size=768, num_attention_heads=12,
                   attention_head_size=64, feed_forward_size=3072,
                   attn_layers=['local', 'lsh'] * 6, axial_pos_shape=[32, 64],
                   axial_pos_embds_dim=[192, 576], max_position_embeddings=2048,
                   local_attn_chunk_length=64, lsh_attn_chunk_length=64,
                   local_num_chunks_before=1, local_num_chunks_after=0,
                   lsh_num_chunks_before=1, lsh_num_chunks_after=0, num_hashes=2,
                   num_buckets=64, hidden_act='relu', hidden_dropout_prob=0.05,
                   layer_norm_eps=1e-12)


def hf_tfxl_checkpoint(seed):
    """An HF TransfoXLLMHeadModel checkpoint made with numpy: a namespace of
    HF's config names (`HF_TFXL`) and a state dict under HF's key names,
    with a tied output embedding and the adaptive head's cluster."""
    hc = SimpleNamespace(**HF_TFXL)
    rng = np.random.default_rng(seed)
    V, d, N, H, F = hc.vocab_size, hc.d_model, hc.n_head, hc.d_head, hc.d_inner
    embed = normal(rng, V, d)
    sd = {'transformer.word_emb.emb_layers.0.weight': embed,
          'crit.out_layers.0.weight': embed, 'crit.out_layers.0.bias': normal(rng, V),
          'crit.cluster_weight': normal(rng, 1, d), 'crit.cluster_bias': normal(rng, 1)}
    for i in range(hc.n_layer):
        p = f'transformer.layers.{i}.'
        sd.update({
            p + 'dec_attn.qkv_net.weight': normal(rng, 3 * N * H, d),
            p + 'dec_attn.r_net.weight': normal(rng, N * H, d),
            p + 'dec_attn.o_net.weight': normal(rng, d, N * H),
            p + 'dec_attn.r_w_bias': normal(rng, N, H, std=0.1),
            p + 'dec_attn.r_r_bias': normal(rng, N, H, std=0.1),
            p + 'dec_attn.layer_norm.weight': 1 + normal(rng, d),
            p + 'dec_attn.layer_norm.bias': normal(rng, d),
            p + 'pos_ff.CoreNet.0.weight': normal(rng, F, d),
            p + 'pos_ff.CoreNet.0.bias': normal(rng, F),
            p + 'pos_ff.CoreNet.3.weight': normal(rng, d, F),
            p + 'pos_ff.CoreNet.3.bias': normal(rng, d),
            p + 'pos_ff.layer_norm.weight': 1 + normal(rng, d),
            p + 'pos_ff.layer_norm.bias': normal(rng, d)})
    return hc, sd


def hf_reformer_checkpoint(seed):
    """An HF ReformerModelWithLMHead checkpoint made with numpy: a namespace
    of HF's config names (`HF_REFORMER`) and a state dict under HF's key
    names, the final norm and head over both streams."""
    hc = SimpleNamespace(**HF_REFORMER)
    rng = np.random.default_rng(seed)
    V, d, F = hc.vocab_size, hc.hidden_size, hc.feed_forward_size
    NH = hc.num_attention_heads * hc.attention_head_size
    (n1, n2), (d1, d2) = hc.axial_pos_shape, hc.axial_pos_embds_dim
    sd = {'reformer.embeddings.word_embeddings.weight': normal(rng, V, d),
          'reformer.embeddings.position_embeddings.weights.0': normal(rng, n1, 1, d1),
          'reformer.embeddings.position_embeddings.weights.1': normal(rng, 1, n2, d2),
          'reformer.encoder.layer_norm.weight': 1 + normal(rng, 2 * d),
          'reformer.encoder.layer_norm.bias': normal(rng, 2 * d),
          'lm_head.decoder.weight': normal(rng, V, 2 * d), 'lm_head.decoder.bias': normal(rng, V)}
    for i, kind in enumerate(hc.attn_layers):
        p = f'reformer.encoder.layers.{i}.'
        sa = p + 'attention.self_attention.'
        if kind == 'local':
            sd.update({sa + 'query.weight': normal(rng, NH, d),
                       sa + 'key.weight': normal(rng, NH, d)})
        else:
            sd[sa + 'query_key.weight'] = normal(rng, NH, d)
        sd.update({
            sa + 'value.weight': normal(rng, NH, d),
            p + 'attention.output.dense.weight': normal(rng, d, NH),
            p + 'attention.layer_norm.weight': 1 + normal(rng, d),
            p + 'attention.layer_norm.bias': normal(rng, d),
            p + 'feed_forward.dense.dense.weight': normal(rng, F, d),
            p + 'feed_forward.dense.dense.bias': normal(rng, F),
            p + 'feed_forward.output.dense.weight': normal(rng, d, F),
            p + 'feed_forward.output.dense.bias': normal(rng, d),
            p + 'feed_forward.layer_norm.weight': 1 + normal(rng, d),
            p + 'feed_forward.layer_norm.bias': normal(rng, d)})
    return hc, sd


def loss_and_grads(model, params, ids, labels, seed):
    """One step's loss and gradients (dropout on, a generator seeded with
    `seed`) and its peak memory, for comparing a knob on and off."""
    leaves = flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=ids.device).manual_seed(seed)
    loss, _ = model.loss(params, ids, labels, generator=gen, deterministic=False)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    out = dict(loss=float(loss.detach()),
               grad_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    for t in leaves.values():
        t.requires_grad_(False)
    return out, dict(zip(leaves, grads))


def remat_pair(name, make_model, params, batch, tok, args, launches, want, report):
    """The same step with the knob off and on: equal loss and gradients
    within TOL_GRAD of each leaf's largest entry -- but for W_r (TF-XL's
    `attn/r`), whose gradient K2 sums with atomics into the distance
    table's and rounds to bf16, so that a rounding may flip from run to
    run: that leaf's gap, and its spread between two runs of the step
    without the knob, are each held within TOL_W_R.  Then each one's
    `Trainer.train_step`, the main training path: its kernel launches,
    counted from 0 around one step and held to `want`, its time and its peak
    memory (the optimizer moves `params`)."""
    runs, grads = {}, {}
    for key, on in (('off', False), ('on', True), ('off-again', False)):
        runs[key], grads[key] = loss_and_grads(make_model(on), params, batch['input_ids'],
                                               batch['labels'], SEED)

    def rel(a, b):
        return {k: rel_max(grads[a][k], grads[b][k]) if grads[b][k].abs().max() > 0
                else float(grads[a][k].abs().max()) for k in grads[b]}
    on_off, spread = rel('on', 'off'), rel('off-again', 'off')
    del grads
    atomic = [k for k in on_off if k.endswith('/attn/r')]
    rest = [k for k in on_off if k not in atomic]
    worst = max(rest, key=on_off.get)
    rec = dict(off=runs['off'], on=runs['on'], worst_grad=worst, worst_grad_rel=on_off[worst],
               w_r_rel=max((on_off[k] for k in atomic), default=0.0),
               w_r_rel_off_vs_off=max((spread[k] for k in atomic), default=0.0),
               loss_off_again=runs['off-again']['loss'])
    leaves = flatten(params)
    for key, on in (('off', False), ('on', True)):
        trainer = tr.Trainer(make_model(on), tok, range(len(batch['input_ids'])), args=args,
                             out_dir=os.path.join(RUN_DIR, 'remat'))
        state = trainer.opt.init(params)
        for t in leaves.values():
            t.requires_grad_(True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in launches:
            launches[k] = 0
        trainer.train_step(params, state, batch)
        torch.cuda.synchronize()
        runs[key]['launches'] = dict(launches)
        runs[key]['step_ms'] = time_ms(lambda: trainer.train_step(params, state, batch),
                                       iters=2, warmup=0)
        runs[key]['step_peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
        for t in leaves.values():
            t.requires_grad_(False)
        del trainer, state
    log(f'[remat] {name}: {json.dumps(rec)}')
    report.setdefault('remat', {})[name] = rec
    if runs['on']['loss'] != runs['off']['loss'] or on_off[worst] > TOL_GRAD or \
            max(rec['w_r_rel'], rec['w_r_rel_off_vs_off']) > TOL_W_R or \
            runs['off']['launches'] != want[False] or runs['on']['launches'] != want[True]:
        raise AssertionError(f'{name}: remat on and off disagree: {rec} (launches wanted {want})')
    return rec


def hf_tfxl_checks(dev, report):
    """Phase 10.1: an HF TF-XL checkpoint at the 22-11 widths, imported
    (`from_hf_transfo_xl`, the window 512 of HF's same_length, the adaptive
    head), through the port's entry points: `score_batch` 8 x 1024 (12
    windowed K1), a forward over a full 512 memory (12 K1), f32 log-probs at
    B 1 card vs CPU and their logsumexp; save, `load_trained`, and
    `MusicGenerator` 2 x 1024 (sample, top_k 8; no K1), every file re-read;
    a training step at 21 x 1024 with `remat_attn` off and on."""
    hc, sd = hf_tfxl_checkpoint(SEED)
    t0 = time.perf_counter()
    cfg, nested = from_hf_transfo_xl(sd, hf_config=hc, max_length=1024)
    params = params_from_jax(nested, dev)
    rec = dict(import_s=time.perf_counter() - t0, config=dataclasses.asdict(cfg))
    if (cfg.attn_window, cfg.mem_len, cfg.adaptive_cutoffs, cfg.model_size) != \
            (hc.mem_len, hc.mem_len, tuple(hc.cutoffs), 'hf-import'):
        raise AssertionError(f'the imported TF-XL config: {cfg}')
    tok = MusicTokenizer(pitch_kind='degree', model_max_length=1024)
    model = TransfoXL(cfg)
    ids, labels = score_inputs(cfg.vocab_size, 8, 1024, SEED + 50, dev)
    key_scores = torch.from_numpy(
        np.random.default_rng(SEED + 51).random((21, N_KEY)).astype(np.float32)).to(dev)
    ikr = IkrMetric(tok, mode='vanilla')
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    mets = score_batch(model, params, ids, labels, ikr, key_scores[:8])
    torch.cuda.synchronize()
    rec['score'] = {k: float(v) for k, v in mets.items()}
    rec['score_launches'] = dict(fa.LAUNCHES)
    rec['score_ms'] = time_ms(lambda: score_batch(model, params, ids, labels, ikr,
                                                  key_scores[:8]), iters=3, warmup=0)
    if rec['score_launches'] != dict(flash_rel_attn_fwd=cfg.n_layer, flash_rel_attn_bwd=0) or \
            not all(math.isfinite(v) for v in rec['score'].values()) or \
            abs(rec['score']['loss'] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f'scoring the imported TF-XL: {rec}')
    with torch.no_grad():
        mems = torch.zeros(cfg.n_layer, 8, cfg.mem_len, cfg.d_model, dtype=cfg.compute_dtype,
                           device=dev)
        fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
        logits, new_mems, valid = model.forward(params, ids, mems=mems, mem_valid=cfg.mem_len)
        torch.cuda.synchronize()
        rec['memory_forward_launches'] = dict(fa.LAUNCHES)
        if rec['memory_forward_launches'] != dict(flash_rel_attn_fwd=cfg.n_layer,
                                                  flash_rel_attn_bwd=0) or \
                not torch.isfinite(logits).all() or int(valid) != cfg.mem_len:
            raise AssertionError(f'the imported TF-XL over a 512 memory: {rec}')
        del logits, new_mems, mems
        cfg32 = dataclasses.replace(cfg, dtype='float32')
        card, _, _ = TransfoXL(cfg32).forward(params, ids[:1])
        cpu, _, _ = TransfoXL(cfg32, device='cpu').forward(params_from_jax(nested, 'cpu'),
                                                          ids[:1].cpu())
        rec['f32_card_vs_cpu'] = rel_max(card, cpu)
        rec['f32_lse_max'] = float(torch.logsumexp(card, -1).abs().max())
        del card, cpu
    if not rec['f32_card_vs_cpu'] <= TOL_F32_LOGITS or not rec['f32_lse_max'] <= TOL_LSE:
        raise AssertionError(f'the imported TF-XL in f32, card vs CPU: {rec}')

    # save, load_trained and generate over the windowed KV ring (no K1)
    run = os.path.join(RUN_DIR, 'hf-tfxl')
    shutil.rmtree(run, ignore_errors=True)
    save_pytree(os.path.join(run, 'trained'), params)
    save_meta(os.path.join(run, 'meta.json'), dict(
        model_name='transf-xl', config=dataclasses.asdict(cfg),
        tokenizer=tr.describe_tokenizer(tok, run)))
    lmodel, lparams, ltok = load_trained(run, device=dev)
    if lmodel.cfg != cfg:
        raise AssertionError(f'load_trained changed the imported config: {lmodel.cfg}')
    out_dir = os.path.join(run, 'generated')
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    t0 = time.perf_counter()
    with DecodeTimer() as timer:
        MusicGenerator(lmodel, ltok, lparams, out_dir=out_dir)(
            mode='unconditional', strategy='sample', n_song=2, max_length=1024, top_k=8,
            seed=SEED)
    with_rendering = time.perf_counter() - t0
    bars, valid = check_rendered(out_dir, 2)
    rec['generate'] = dict(timer.summary(ltok.vocab), seconds_with_rendering=with_rendering,
                           launches=dict(fa.LAUNCHES), bars=bars, bar_durations_valid=valid)
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f'generation from the imported TF-XL launched a kernel: {rec}')
    del lmodel, lparams

    # a training step at 21 x 1024 (dropout 0.1), remat_attn off and on
    tids, tlabels = score_inputs(cfg.vocab_size, 21, 1024, SEED + 52, dev)
    batch = dict(input_ids=tids, labels=tlabels, key_scores=key_scores)
    n = cfg.n_layer
    remat_pair('hf-tfxl-21x1024', lambda on: TransfoXL(dataclasses.replace(cfg, remat_attn=on)),
               params, batch, tok, train_args(seed=SEED), fa.LAUNCHES,
               {False: dict(flash_rel_attn_fwd=n, flash_rel_attn_bwd=n),
                True: dict(flash_rel_attn_fwd=2 * n, flash_rel_attn_bwd=n)}, report)
    log(f'[hf-tfxl] {json.dumps({k: v for k, v in rec.items() if k != "config"})}')
    report['hf_tfxl'] = rec
    del params, model
    torch.cuda.empty_cache()


def largest_bucket(state) -> int:
    """The most positions any (layer, row, head, round) bucket holds in a
    'scan' decode state's bucket cache."""
    sb = state.lsh_buckets.long()
    return max(int((sb == b).sum(-1).max()) for b in range(int(sb.max()) + 1))


def decode_logits(model, params, ids):
    """Teacher-forced decode logits [B, n, V] over ids [B, n], and the state."""
    st, out = model.init_decode_state(ids.shape[0]), []
    with torch.no_grad():
        for t in range(ids.shape[1]):
            lg, st = model.decode_step(params, ids[:, t], st)
            out.append(lg)
    return torch.stack(out, 1), st


def hf_reformer_checks(dev, report):
    """Phase 10.2: an HF Reformer checkpoint at the 22-04 widths, imported
    (`from_hf_reformer`: hf_compat, two streams, [2 d] head): `score_batch`
    8 x 2048 (12 K3); f32 logits at depth 2, card vs CPU on shared
    branches; a training step at 32 x 2048 with `remat` (24 K3, 12 K4);
    2 x 1024 sampled songs (top_p 0.9, 'scan'); 128 greedy tokens through
    'scan', the streamed scan (decode_scan_chunk 512) and 'bounded'
    (decode_window 32), each twice, each one's tok/s and peak memory; in f32 at B 1,
    the streamed scan and 'bounded' (its window at least the largest
    bucket) against 'scan'; one contrastive search over the [2 d] hidden."""
    hc, sd = hf_reformer_checkpoint(SEED + 1)
    cfg, nested = from_hf_reformer(sd, hf_config=hc)
    params = params_from_jax(nested, dev)
    if not cfg.hf_compat or cfg.ln_eps != 1e-12 or \
            cfg.lsh_buckets_at(cfg.max_length) != hc.num_buckets:
        raise AssertionError(f'the imported Reformer config: {cfg}')
    rec = dict(config=dataclasses.asdict(cfg))
    rtok = MusicTokenizer(pitch_kind='midi', model_max_length=2048)
    model = Reformer(cfg)
    n_layer = len(cfg.attn_layers)
    ids, labels = score_inputs(cfg.vocab_size, 32, cfg.max_length, SEED + 60, dev)
    key_scores = torch.from_numpy(
        np.random.default_rng(SEED + 61).random((32, N_KEY)).astype(np.float32)).to(dev)
    ikr = IkrMetric(rtok, mode='vanilla')
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    mets = score_batch(model, params, ids[:8], labels[:8], ikr, key_scores[:8])
    torch.cuda.synchronize()
    rec['score'] = {k: float(v) for k, v in mets.items()}
    rec['score_launches'] = dict(ck.LAUNCHES)
    rec['score_ms'] = time_ms(lambda: score_batch(model, params, ids[:8], labels[:8], ikr,
                                                  key_scores[:8]), iters=3, warmup=0)
    if rec['score_launches'] != dict(chunked_window_attn_fwd=n_layer,
                                     chunked_window_attn_bwd=0) or \
            not all(math.isfinite(v) for v in rec['score'].values()) or \
            abs(rec['score']['loss'] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f'scoring the imported Reformer: {rec}')

    # f32 logits at depth 2 (one local, one LSH layer), card vs CPU
    hc2 = SimpleNamespace(**dict(vars(hc), attn_layers=hc.attn_layers[:2]))
    cfg2, nested2 = from_hf_reformer(sd, hf_config=hc2, dtype='float32')
    outs = []
    with SharedBranches() as shared, torch.no_grad():
        for device in (dev, torch.device('cpu')):
            outs.append(Reformer(cfg2, device=device).forward(
                params_from_jax(nested2, device), ids[:1].to(device)).cpu())
            shared.recorded, shared.replaying = shared.seen, True
    rec['f32_depth2_card_vs_cpu'] = rel_max(outs[0], outs[1])
    rec['f32_depth2_branches_differing'] = dict(shared.differ)
    del outs
    if not rec['f32_depth2_card_vs_cpu'] <= TOL_F32_LOGITS:
        raise AssertionError(f'the imported Reformer in f32, card vs CPU: {rec}')

    # one training step at 32 x 2048 with remat, counted and timed
    rmodel = Reformer(dataclasses.replace(cfg, remat=True))
    trainer = tr.Trainer(rmodel, rtok, range(32), args=reformer_train_args(seed=SEED),
                         out_dir=os.path.join(RUN_DIR, 'hf-reformer'))
    state = trainer.opt.init(params)
    batch = dict(input_ids=ids, labels=labels, key_scores=key_scores)
    leaves = flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    step_mets = trainer.train_step(params, state, batch)
    torch.cuda.synchronize()
    rec['train_launches'] = dict(ck.LAUNCHES)
    rec['train_loss'] = float(step_mets['loss'])
    rec['train_grad_norm'] = float(step_mets['grad_norm'])
    rec['train_step_ms'] = time_ms(lambda: trainer.train_step(params, state, batch), iters=2,
                                   warmup=0)
    rec['train_peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    for t in leaves.values():
        t.requires_grad_(False)
    del trainer, state, batch, step_mets
    torch.cuda.empty_cache()
    if rec['train_launches'] != dict(chunked_window_attn_fwd=2 * n_layer,
                                     chunked_window_attn_bwd=n_layer) or \
            not math.isfinite(rec['train_loss']) or not math.isfinite(rec['train_grad_norm']):
        raise AssertionError(f'the imported Reformer training step with remat: {rec}')

    # decode: 2 sampled songs through 'scan', then 128 greedy tokens per estimator
    gen = MusicGenerator(model, rtok, params)
    prompts = [gen.unconditional_prompt(time_sig=(4, 4), tempo=120),
               gen.unconditional_prompt(time_sig=(3, 4), tempo=90)]
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = gen.generate(prompts, strategy='sample', seed=SEED, max_length=GEN_LEN, top_p=0.9)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    new = sum(len(t_.split()) - len(p_.split()) for t_, p_ in zip(texts, prompts))
    rec['sample'] = dict(seconds=dt, new_tokens=new, decode_tok_per_s=new / dt,
                         lengths=[len(t_.split()) for t_ in texts])
    plen = len(prompts[0].split())
    estimators = {'scan': dict(), f'scan-chunk-{SCAN_CHUNK}': dict(decode_scan_chunk=SCAN_CHUNK),
                  'bounded-w32': dict(decode_mode='bounded', decode_window=32)}
    # each estimator twice, in the order a b c c b a: the decode is paced by
    # the shared host, so one call alone does not rank them
    rec['greedy'] = {label: dict(decode_tok_per_s=[], seconds=[], peak_gib=[])
                     for label in estimators}
    outs = {}
    for label in list(estimators) + list(estimators)[::-1]:
        g = MusicGenerator(Reformer(dataclasses.replace(cfg, **estimators[label])), rtok, params)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = g.generate(prompts, strategy='greedy', max_length=plen + GREEDY_LEN,
                         early_exit_chunk=0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        new = sum(len(t_.split()) - plen for t_ in out)
        r = rec['greedy'][label]
        r['decode_tok_per_s'].append(new / dt)
        r['seconds'].append(dt)
        r['peak_gib'].append(torch.cuda.max_memory_allocated() / 2 ** 30)
        r['same_tokens_twice'] = outs.setdefault(label, out) == out
        texts += out
    for label, out in outs.items():
        rec['greedy'][label]['same_tokens_as_scan'] = out == outs['scan']
    for t_ in texts:
        if any(x not in rtok.vocab.tok2id for x in t_.split()):
            raise AssertionError(f'a generated token is not in the vocabulary: {t_[:200]}')
    if any(ck.LAUNCHES.values()):
        raise AssertionError(f'Reformer decode launched a kernel: {dict(ck.LAUNCHES)}')

    # f32 B 1, teacher forced over two streamed chunks and a bit: the
    # streamed scan and 'bounded' against the one-pass scan
    # (on the scan's bucket ids and relu branches: an f32 rounding that lands
    # another way can flip a hash on a near-tie, and the estimators are held
    # to their arithmetic, not to that luck)
    p32 = params_from_jax(nested, dev)
    fids = ids[:1, :SCAN_CHUNK + SCAN_CHUNK // 4]
    cfg32 = dataclasses.replace(cfg, dtype='float32')
    with SharedBranches() as shared:
        ref, st = decode_logits(Reformer(cfg32), p32, fids)
        occupancy = largest_bucket(st)
        window = max(32, occupancy)
        shared.replay()
        chunked, _ = decode_logits(Reformer(dataclasses.replace(
            cfg32, decode_scan_chunk=SCAN_CHUNK)), p32, fids)
        shared.replay()
        bounded, _ = decode_logits(Reformer(dataclasses.replace(
            cfg32, decode_mode='bounded', decode_window=window)), p32, fids)
    rec['f32_decode'] = dict(steps=fids.shape[1], largest_bucket=occupancy,
                             bounded_window=window, chunked_vs_scan=rel_max(chunked, ref),
                             bounded_vs_scan=rel_max(bounded, ref),
                             branches_differing=dict(shared.differ),
                             branches=dict(shared.total))
    del ref, chunked, bounded, p32, shared
    if not (rec['f32_decode']['chunked_vs_scan'] <= TOL_F32_LOGITS and
            rec['f32_decode']['bounded_vs_scan'] <= TOL_F32_LOGITS):
        raise AssertionError(f'the Reformer decode estimators disagree: {rec["f32_decode"]}')

    # contrastive search over the [2 d] hidden
    t0 = time.perf_counter()
    (ctext,) = gen.generate(prompts[:1], strategy='contrastive', top_k=4, penalty_alpha=0.6,
                            max_length=CONTRASTIVE_LEN)
    torch.cuda.synchronize()
    rec['contrastive'] = dict(seconds=time.perf_counter() - t0, length=len(ctext.split()),
                              hidden_dim=model.hidden_dim)
    if model.hidden_dim != 2 * cfg.d_model or not ctext.startswith(prompts[0]) or \
            any(x not in rtok.vocab.tok2id for x in ctext.split()):
        raise AssertionError(f'contrastive search over the imported Reformer: {rec}')
    log(f'[hf-reformer] {json.dumps({k: v for k, v in rec.items() if k != "config"})}')
    report['hf_reformer'] = rec
    del params, model, gen
    torch.cuda.empty_cache()


def native_remat_checks(dev, report):
    """Phase 10.3: the native 22-04 model (what users train) with remat, one
    step at 32 x 2048 against the same step without it."""
    cfg = reformer_config()
    params = params_from_jax(Reformer(cfg, device='cpu').init_flat(SEED), dev)
    rtok = MusicTokenizer(pitch_kind='midi', model_max_length=2048)
    ids, labels = score_inputs(cfg.vocab_size, 32, cfg.max_length, SEED + 70, dev)
    key_scores = torch.from_numpy(
        np.random.default_rng(SEED + 71).random((32, N_KEY)).astype(np.float32)).to(dev)
    n = len(cfg.attn_layers)
    remat_pair('reformer-22-04-32x2048', lambda on: Reformer(dataclasses.replace(cfg, remat=on)),
               params, dict(input_ids=ids, labels=labels, key_scores=key_scores), rtok,
               reformer_train_args(seed=SEED), ck.LAUNCHES,
               {False: dict(chunked_window_attn_fwd=n, chunked_window_attn_bwd=n),
                True: dict(chunked_window_attn_fwd=2 * n, chunked_window_attn_bwd=n)}, report)
    del params
    torch.cuda.empty_cache()


def hf_interop_phase(dev, report):
    """Phase 10, each part counted and timed."""
    t0 = time.perf_counter()
    seconds = {}
    for name, fn in (('hf tf-xl', hf_tfxl_checks), ('hf reformer', hf_reformer_checks),
                     ('native remat', native_remat_checks)):
        t1 = time.perf_counter()
        fn(dev, report)
        seconds[name] = time.perf_counter() - t1
    report['phase10_seconds'] = dict(seconds, total=time.perf_counter() - t0)
    log(f'[phase 10] seconds: {json.dumps(report["phase10_seconds"])}')


# ---------------- C.1, the analysis modules and the download command (phase 11)
# bf16 / f16 TF-XL logits against the port's f32 CPU logits, over their
# largest entry: 16-bit operands in every product and layer norm of 2
# layers.  Measured on an H100: bf16 1.14e-3 at head dim 128 (f16's 2^-11
# rounding is 8x finer than bf16's 2^-8).  A control must land at least 4x
# outside the limit: the f32 logits with every layer's attention output
# dropped (its `o` projection zeroed), 0.154 of their max at head dim 128
TOL_16_LOGITS = {torch.float16: 2e-3, torch.bfloat16: 1e-2}
# PitchEmbedding, card vs CPU, over emb_in's largest entry: the same f32 SGD,
# whose row gradients `index_add_` sums with atomics in another order
TOL_W2V = 1e-4
W2V_SONGS = 8                                    # rendered .mxl songs PitchEmbedding trains on
TRACES = 3                                       # traced 22-11 steps, each must name K1 / K2 12x
D128 = dict(d_model=1024, n_head=8, d_head=128, d_inner=4096)   # C.1's head dim 128
D256 = dict(d_model=1024, n_head=4, d_head=256, d_inner=4096)   # C.2's: four slabs of 64
D192 = dict(d_model=768, n_head=4, d_head=192)                  # C.2's, padded to 256


def counted(fn):
    """fn() with the K1-K4 counts set to 0 just before and read just after
    -> (fn's result, counts)."""
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    out = fn()
    torch.cuda.synchronize()
    return out, dict(**fa.LAUNCHES, **ck.LAUNCHES)


def expect(counts, **want):
    """The counts, each absent name 0 -> raises unless they are `want`."""
    full = dict(dict.fromkeys(counts, 0), **want)
    if counts != full:
        raise AssertionError(f'launch counts {counts}, expected {full}')


def logits_vs_cpu(cfg, card_fwd, cpu_fwd, cpu_params, o_leaves):
    """card_fwd() against cpu_fwd(cpu_params), the port's CPU run in f32,
    over the CPU logits' largest entry -> (err, tol, control): f32 at
    TOL_F32_LOGITS; 16 bits at TOL_16_LOGITS, with a control (the CPU run
    with every attention output projection in `o_leaves` zeroed) that must
    miss by more than 4x the limit."""
    with torch.no_grad():
        got = card_fwd()                              # first: SharedBranches records it
        want = cpu_fwd(cpu_params)
        err = rel_max(got, want)
        if cfg.dtype == 'float32':
            return err, TOL_F32_LOGITS, None
        for o in o_leaves:
            o.zero_()
        return err, TOL_16_LOGITS[cfg.compute_dtype], rel_max(cpu_fwd(cpu_params), want)


def hold_scores(tag, name, desc, score, ms, counts, err, tol, control):
    """Log a score_batch run held against the CPU -> its record; raises on a
    non-finite loss, err over tol, or a control within 4x tol."""
    loss = float(score['loss'])
    log(f'[{tag}] {name}, depth 2, {desc}: score_batch {ms:.2f} ms, loss {loss:.5f}; card vs '
        f'CPU f32 logits {err:.2e} of their max (tol {tol}; attention dropped: {control}); '
        f'counts {counts}')
    if not (math.isfinite(loss) and err <= tol) or (control is not None and control <= 4 * tol):
        raise AssertionError(f'{tag} {name}: card vs CPU logits {err}, control {control}')
    return dict(counts=counts, score_ms=ms, loss=loss, logits_err=err, tol=tol,
                control_err=control)


def tfxl_score_vs_cpu(dev, tag, name, kw):
    """A depth-2 TF-XL at the 22-11 widths changed by `kw` scores 2 x 1024
    ids through `score_batch` on K1 (each layer once, counted), held against
    the port's CPU run in f32 (`logits_vs_cpu`)."""
    tok = MusicTokenizer(pitch_kind='degree', model_max_length=1024)
    ikr = IkrMetric(tok, mode='ins-key')
    ids, labels = score_inputs(1190, 2, 1024, SEED + 80, dev)
    cfg = base_config(n_layer=2, **kw)
    cpu = TransfoXL(dataclasses.replace(cfg, dtype='float32'), device='cpu')
    flat = cpu.init_flat(SEED)
    model, params = TransfoXL(cfg), params_from_jax(flat, dev)
    mets, counts = counted(lambda: score_batch(model, params, ids, labels, ikr))
    expect(counts, flash_rel_attn_fwd=cfg.n_layer)
    ms = time_ms(lambda: score_batch(model, params, ids, labels, ikr), iters=3, warmup=1)
    cpu_params = params_from_jax(flat, 'cpu')
    held = logits_vs_cpu(cfg, lambda: model.forward(params, ids)[0],
                         lambda p: cpu.forward(p, ids.cpu())[0], cpu_params,
                         [layer['attn']['o'] for layer in cpu_params['layers']])
    return hold_scores(tag, name, '2 x 1024', mets, ms, counts, *held)


def reformer_score_vs_cpu(dev, tag, name, **cfg_kw):
    """A depth-2 Reformer base (one local and one LSH layer; `cfg_kw` changes
    the configuration) scores 2 x 2048 ids through `score_batch` on K3 (each
    layer once, counted), held against the port's CPU run in f32
    (`logits_vs_cpu`), the CPU on the card's LSH buckets and relu branches
    (`SharedBranches`: 16-bit hidden states may hash a near-tie elsewhere)."""
    cfg = reformer_config(attn_layers=('local', 'lsh'), **cfg_kw)
    cpu = Reformer(dataclasses.replace(cfg, dtype='float32'), device='cpu')
    flat = cpu.init_flat(SEED)
    model, params = Reformer(cfg), params_from_jax(flat, dev)
    ids, labels = score_inputs(cfg.vocab_size, 2, cfg.max_length, SEED + 82, dev)
    ikr = IkrMetric(MusicTokenizer(pitch_kind='midi'))
    score = lambda: score_batch(model, params, ids, labels, ikr, torch.ones(2, N_KEY, device=dev))
    mets, counts = counted(score)
    expect(counts, chunked_window_attn_fwd=len(cfg.attn_layers))
    ms = time_ms(score, iters=3, warmup=1)
    cpu_params = params_from_jax(flat, 'cpu')

    first = {}                                        # the branches the CPU itself would take

    def cpu_fwd(p):
        shared.replay()                               # the card's branches, for each CPU run
        logits = cpu.forward(p, ids.cpu())
        first.setdefault('branches_differing', dict(shared.differ))
        first.setdefault('branches', dict(shared.total))
        return logits
    with SharedBranches() as shared:
        held = logits_vs_cpu(cfg, lambda: model.forward(params, ids), cpu_fwd, cpu_params,
                             [layer['attn']['o'] for layer in cpu_params['layers']])
    return dict(hold_scores(tag, name, f'2 x {cfg.max_length}, CPU on the card\'s branches '
                            f'({first["branches_differing"]} of {first["branches"]} its own '
                            f'differ)', mets, ms, counts, *held), **first)


def reformer_16bit_step(dev, **cfg_kw):
    """A bf16 training step (loss and every gradient) of a depth-2 Reformer
    base (one local and one LSH layer; `cfg_kw` changes the configuration),
    B 2, T 2048, dropout 0: each layer launches K3 and K4 once (counted),
    and the loss and gradients are finite.  Its f32 twin is held against
    the CPU's gradients (`reformer_card_vs_cpu`); this runs the 16-bit K4
    inside a model step."""
    cfg = reformer_config(attn_layers=('local', 'lsh'), dropout=0.0, **cfg_kw)
    model = Reformer(cfg)
    params = params_from_jax(model.init_flat(SEED), dev)
    leaves = flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    ids, labels = score_inputs(cfg.vocab_size, 2, cfg.max_length, SEED + 84, dev)

    def step():
        loss, _ = model.loss(params, ids, labels)
        return loss, torch.autograd.grad(loss, list(leaves.values()))
    (loss, grads), counts = counted(step)
    expect(counts, chunked_window_attn_fwd=2, chunked_window_attn_bwd=2)
    loss = float(loss.detach())
    finite = math.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads)
    log(f'[c2] reformer {cfg.dtype} step {cfg_kw}, depth 2, 2 x {cfg.max_length}: loss '
        f'{loss:.5f}, every gradient finite: {finite}; counts {counts}')
    if not finite:
        raise AssertionError(f'C.2 Reformer {cfg.dtype} step: a loss or gradient is not finite')
    return dict(counts=counts, loss=loss)


def c2_checks(dev, report):
    """Phase 11.1b, ROADMAP C.2: head dims above 128, which the TPU kernels
    take padded to lanes of 128.  TF-XLs at head dim 256 (d_model 1024, 4
    heads) and 192 (d_model 768, 4 heads, zero-padded to 256 at the layer's
    scale) and a Reformer at head dim 256 (12 heads), depth 2: the TF-XLs
    score through K1's slab kernel in f32 and in 16 bits, held against the
    CPU's f32 logits; a training step of each f32 TF-XL (K1 + K2) and of the
    f32 Reformer (K3 + K4, local and LSH layers) against the CPU's loss and
    gradients; then the Reformer scores in bf16 on K3 (counted), held
    against the CPU's f32 logits as the TF-XLs are, and takes a bf16 step
    (K3 + K4, counted)."""
    rec = {}
    for name, kw in (('tfxl-d256-f32', dict(D256, dtype='float32')),
                     ('tfxl-d256-bf16', dict(D256, dtype='bfloat16')),
                     ('tfxl-d192-f32', dict(D192, dtype='float32')),
                     ('tfxl-d192-f16', dict(D192, dtype='float16'))):
        rec[name] = tfxl_score_vs_cpu(dev, 'c2', name, kw)
    torch.cuda.empty_cache()
    card_vs_cpu_grads(dev, report, key='c2_tfxl_d256_grads', share_branches=True, **D256)
    card_vs_cpu_grads(dev, report, key='c2_tfxl_d192_grads', share_branches=True, **D192)
    reformer_card_vs_cpu(dev, report, key='c2_reformer_d256', d_head=256)
    rec['reformer-d256-bf16'] = reformer_score_vs_cpu(dev, 'c2', 'reformer-d256-bf16',
                                                      d_head=256)
    rec['reformer-d256-bf16-step'] = reformer_16bit_step(dev, d_head=256)
    report['c2'] = rec
    torch.cuda.empty_cache()


def c1_checks(dev, report):
    """Phase 11.1, ROADMAP C.1: a TF-XL at head dim 128 (d_model 1024, 8
    heads) in f32 and bf16, one in float16 at the 22-11 widths, and a
    Reformer with local_chunk 128 (the LSH layer keeps chunk 64), depth 2:
    each scores through `score_batch` on K1 / K3 (f32 on k1_slab and
    k3_slab; bf16 and f16 on k1_tc), held against the port's CPU run in
    f32, the Reformer's scoring traced (k3_slab in both layers, no other K3
    kernel); a training step of the f32 head-dim-128 TF-XL and of the
    Reformer (K2 / K4) against the CPU's gradients."""
    rec = {}
    for name, kw in (('tfxl-d128-f32', dict(D128, dtype='float32')),
                     ('tfxl-d128-bf16', dict(D128, dtype='bfloat16')),
                     ('tfxl-fp16', dict(dtype='float16'))):
        rec[name] = tfxl_score_vs_cpu(dev, 'c1', name, kw)
    torch.cuda.empty_cache()
    card_vs_cpu_grads(dev, report, key='c1_tfxl_d128_grads', share_branches=True, **D128)

    # the Reformer: a step card vs CPU (loss, every gradient; every f32 K3 /
    # K4 call on the slab kernels, chunk 128 in the local layer, 64 in the
    # LSH layer), then its scoring time and kernels by name
    reformer_card_vs_cpu(dev, report, key='c1_reformer_chunk128', local_chunk=128)
    cfg = reformer_config(dtype='float32', attn_layers=('local', 'lsh'), local_chunk=128)
    model = Reformer(cfg)
    params = params_from_jax(model.init_flat(SEED), dev)
    rids, rlabels = score_inputs(cfg.vocab_size, 2, cfg.max_length, SEED + 81, dev)
    rikr = IkrMetric(MusicTokenizer(pitch_kind='midi'))
    rks = torch.ones(2, N_KEY, device=dev)
    score = lambda: score_batch(model, params, rids, rlabels, rikr, rks)
    mets, counts = counted(score)
    expect(counts, chunked_window_attn_fwd=2)
    ms = time_ms(score, iters=3, warmup=1)
    _, kernels, _ = traced_step(os.path.join(RUN_DIR, 'trace-c1-score'), score)
    names = named(kernels, 'k3_slab', 'k3_union_tc', 'k3_tc')
    rec['reformer-chunk128-f32'] = dict(counts=counts, score_ms=ms, loss=float(mets['loss']),
                                        err=report['c1_reformer_chunk128']['rel'], named=names)
    log(f'[c1] reformer-chunk128-f32, depth 2, 2 x 2048: score_batch {ms:.2f} ms, loss '
        f'{float(mets["loss"]):.5f}; counts {counts}; K3 kernels by name {names}')
    if not math.isfinite(float(mets['loss'])) or names != dict(k3_slab=2, k3_union_tc=0,
                                                                k3_tc=0):
        raise AssertionError(f'C.1 Reformer chunk 128: loss {mets}, K3 kernels {names}')
    report['c1'] = rec
    del model, params
    torch.cuda.empty_cache()


def traced_presets(dev, report):
    """Phase 11.2: a 22-11 `Trainer.train_step` at phase 3's shape (TF-XL
    base, 21 x 1024, bf16) inside `device_trace`, 3 times, each after a
    traced warm-up step, each trace naming K1's and K2's kernels 12 times in
    the step it reads (`step_kernels`); `StepTimer` over 3 more steps; and one
    22-04 step (Reformer base, bf16) at 2 x 2048: the presets launch K1-K4
    at phases 3 and 6's counts."""
    tok = MusicTokenizer(pitch_kind='degree', model_max_length=1024)
    cfg, B = base_config(dropout=0.1), 21
    rows = SyntheticSongs(tok, B, SEED + 82)
    trainer = tr.Trainer(TransfoXL(cfg), tok, rows, None, out_dir=os.path.join(RUN_DIR, 'trace'),
                         args=train_args(seed=SEED))
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    for t in flatten(params).values():
        t.requires_grad_(True)
    state = trainer.opt.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(rows.batches(B, seed=1)).items()}
    step = lambda: trainer.train_step(params, state, batch)
    traces = []
    step()                                                      # warm-up, untraced
    for _ in range(TRACES):
        t0 = time.perf_counter()
        with device_trace(os.path.join(RUN_DIR, 'trace')) as path:
            step()                            # absorbs the profiler's losses at the start
            torch.cuda.synchronize()
            time.sleep(TRACE_PAUSE_S)         # the idle gap `step_kernels` reads after
            t1 = time.perf_counter()
            (_, counts) = counted(step)
            traced_ms = (time.perf_counter() - t1) * 1e3
        expect(counts, flash_rel_attn_fwd=cfg.n_layer, flash_rel_attn_bwd=cfg.n_layer)
        kernels = step_kernels(path)
        traces.append(dict(
            step_ms=traced_ms, seconds=time.perf_counter() - t0,   # with start, stop and export
            kernels=sum(kernels.values()), kernel_names=len(kernels),
            mib=os.path.getsize(path) / 2 ** 20,
            named={k: sum(n for name, n in kernels.items() if k in name)
                   for k in ('k1_tc', 'k2_dkdv_tc', 'k2_dq_tc')}))
    timer = StepTimer()
    for _ in range(3):
        step()
        torch.cuda.synchronize()
        timer.mark(n_tokens=B * cfg.max_length)
    timed = timer.summary()
    top = [(name[:60], n) for name, n in sorted(kernels.items(), key=lambda kv: -kv[1])[:3]]
    log(f'[trace] 22-11 train_step 21 x 1024 bf16 in device_trace (after a traced warm-up '
        f'step), {TRACES} traces: step ms while traced '
        f'{[round(t["step_ms"], 1) for t in traces]}, s with both steps and the trace written '
        f'{[round(t["seconds"], 2) for t in traces]}; the step\'s kernels '
        f'{[t["kernels"] for t in traces]} in {traces[-1]["kernel_names"]} names, '
        f'{traces[-1]["mib"]:.1f} MiB each; K1 / K2 by '
        f'name {[t["named"] for t in traces]}; most launched {top}; StepTimer over 3 steps: '
        f'{timed["tokens_per_sec"]:.0f} tok/s, p50 {timed["p50_step_s"] * 1e3:.1f} ms')
    if any(set(t['named'].values()) != {cfg.n_layer} for t in traces):
        raise AssertionError(f'a trace names K1 / K2 other than {cfg.n_layer} times each: '
                             f'{[t["named"] for t in traces]}')
    report['trace'] = dict(counts=counts, traces=traces, step_timer=timed)
    del trainer, params, state, batch
    torch.cuda.empty_cache()

    rcfg = reformer_config()
    rtok = MusicTokenizer(pitch_kind='midi', model_max_length=rcfg.max_length)
    rrows = SyntheticSongs(rtok, 2, SEED + 83, length=rcfg.max_length, insert_key=False)
    trainer = tr.Trainer(Reformer(rcfg), rtok, rrows, None, out_dir=os.path.join(RUN_DIR, 'trace'),
                         args=reformer_train_args(batch_size=2, seed=SEED))
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    for t in flatten(params).values():
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(rrows.batches(2, seed=1)).items()}
    mets, counts = counted(lambda: trainer.train_step(params, trainer.opt.init(params), batch))
    n = len(rcfg.attn_layers)
    log(f'[trace] 22-04 train_step 2 x 2048 bf16: loss {float(mets["loss"]):.4f}, counts {counts}')
    expect(counts, chunked_window_attn_fwd=n, chunked_window_attn_bwd=n)
    report['trace']['reformer_counts'] = counts
    del trainer, params, batch
    torch.cuda.empty_cache()


def traced_step(trace_dir, step):
    """`step` traced after a traced warm-up of it (as `traced_presets` reads
    a step) -> (counts of the read step, its kernels by name, its ms)."""
    with device_trace(trace_dir) as path:
        step()                                # absorbs the profiler's losses at the start
        torch.cuda.synchronize()
        time.sleep(TRACE_PAUSE_S)             # the idle gap `step_kernels` reads after
        t1 = time.perf_counter()
        _, counts = counted(step)
        ms = (time.perf_counter() - t1) * 1e3
    return counts, step_kernels(path), ms


def named(kernels, *names):
    """Launches of the kernels whose names hold each of `names`."""
    return {n: sum(c for k, c in kernels.items() if n in k) for n in names}


def c1_traces(dev, report):
    """Phase 11.2: one bf16 `Trainer.train_step` of a head-dim-128 TF-XL
    (d_model 1024, 8 heads, depth 2, 2 x 1024) and one of a Reformer with
    local_chunk 128 (local + LSH, depth 2, 2 x 2048), each in `device_trace`
    after a traced warm-up: K1 and K2 run on their tensor-core kernels at
    head dim 128 (k1_tc once per layer, k2_dkdv_tc / k2_dq_tc once per
    layer), K3 on its tensor-core walk at chunk 128 and k3_tc at the LSH
    layer's 64, K4 on its tensor-core tiled split (and k4_tc at 64), by name
    in the trace, with none of K3's FMA kernels and none of the slab
    kernels (f32 and head dims above 128 only)."""
    rec = {}
    trace_dir = os.path.join(RUN_DIR, 'trace-c1')
    tok = MusicTokenizer(pitch_kind='degree', model_max_length=1024)
    cfg = base_config(n_layer=2, dtype='bfloat16', **D128)
    rows = SyntheticSongs(tok, 2, SEED + 84)
    trainer = tr.Trainer(TransfoXL(cfg), tok, rows, None, out_dir=trace_dir,
                         args=train_args(seed=SEED, batch_size=2))
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    for t in flatten(params).values():
        t.requires_grad_(True)
    state = trainer.opt.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(rows.batches(2, seed=1)).items()}
    counts, kernels, ms = traced_step(trace_dir, lambda: trainer.train_step(params, state, batch))
    expect(counts, flash_rel_attn_fwd=cfg.n_layer, flash_rel_attn_bwd=cfg.n_layer)
    rec['tfxl-d128-bf16'] = dict(step_ms=ms, counts=counts, named=named(
        kernels, 'k2_dkdv_tc', 'k2_dq_tc', 'k2_dkdv_slab', 'k2_dq_slab', 'k1_slab', 'k1_tc'))
    want = dict(k2_dkdv_tc=cfg.n_layer, k2_dq_tc=cfg.n_layer, k2_dkdv_slab=0, k2_dq_slab=0,
                k1_slab=0, k1_tc=cfg.n_layer)
    log(f'[trace] C.1 TF-XL d128 bf16 train_step, depth 2, 2 x 1024: {ms:.1f} ms while traced; '
        f'kernels by name {rec["tfxl-d128-bf16"]["named"]}')
    if rec['tfxl-d128-bf16']['named'] != want:
        raise AssertionError(f'C.1 TF-XL d128 bf16 trace: {rec["tfxl-d128-bf16"]["named"]}, '
                             f'expected {want}')
    del trainer, params, state, batch

    rcfg = reformer_config(attn_layers=('local', 'lsh'), local_chunk=128)
    rtok = MusicTokenizer(pitch_kind='midi', model_max_length=rcfg.max_length)
    rrows = SyntheticSongs(rtok, 2, SEED + 85, length=rcfg.max_length, insert_key=False)
    trainer = tr.Trainer(Reformer(rcfg), rtok, rrows, None, out_dir=trace_dir,
                         args=reformer_train_args(batch_size=2, seed=SEED))
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    for t in flatten(params).values():
        t.requires_grad_(True)
    state = trainer.opt.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(rrows.batches(2, seed=1)).items()}
    counts, kernels, ms = traced_step(trace_dir, lambda: trainer.train_step(params, state, batch))
    expect(counts, chunked_window_attn_fwd=2, chunked_window_attn_bwd=2)
    rec['reformer-chunk128-bf16'] = dict(step_ms=ms, counts=counts, named=named(
        kernels, 'k4_dq_tc', 'k4_dkdv_tc', 'k4_tc', 'k3_union_tc', 'k3_tc', 'k3_slab',
        'k4_dq_slab', 'k4_dkdv_slab'))
    want = dict(k4_dq_tc=1, k4_dkdv_tc=1, k4_tc=1, k3_union_tc=1, k3_tc=1, k3_slab=0,
                k4_dq_slab=0, k4_dkdv_slab=0)
    log(f'[trace] C.1 Reformer local_chunk 128 bf16 train_step, depth 2, 2 x 2048: {ms:.1f} ms '
        f'while traced; kernels by name {rec["reformer-chunk128-bf16"]["named"]}')
    if rec['reformer-chunk128-bf16']['named'] != want:
        raise AssertionError(f'C.1 Reformer chunk 128 bf16 trace: '
                             f'{rec["reformer-chunk128-bf16"]["named"]}, expected {want}')
    report['c1_traces'] = rec
    del trainer, params, state, batch
    torch.cuda.empty_cache()


def analysis_checks(dev, report):
    """Phase 11.3, A.8 over phase 8's run: its 22-04 train log summarized,
    its generated songs through `MusicStats` / `MusicVisualize` (reports, no
    plots), the data's own in-key ratio on the card against the CPU, the
    rendered MusicXML songs to melody grids, and `PitchEmbedding` trained on
    the card and on the CPU from one seed."""
    root = os.path.join(RUN_DIR, 'cli')
    rec = dict(summary=summarize_run(os.path.join(root, '22-04', 'train_log.jsonl')))
    if rec['summary']['n_step'] != 58 // 32 or 'best_eval_loss' not in rec['summary']:
        raise AssertionError(f'summarize_run of the 22-04 CLI run: {rec["summary"]}')
    for gen, pk in (('gen-22-11', 'degree'), ('gen-22-04', 'midi')):
        d = os.path.join(root, gen)
        songs = []
        for f in sorted(os.listdir(d)):
            if f.endswith('.json'):
                with open(os.path.join(d, f)) as fh:
                    songs.append(dict(score=json.load(fh)['text']))
        rep = MusicVisualize(songs, dataset_name=gen, pitch_kind=pk).report()
        stats = [MusicStats(pitch_kind=pk).song_stats(x['score']) for x in songs]
        rec[gen] = dict(report=rep, song_stats=stats)
        if rep['n_song'] != len(songs) or not all(x['n_bar'] >= 1 for x in stats):
            raise AssertionError(f'{gen}: {rep} {stats}')
    log(f'[analysis] summarize_run 22-04: {json.dumps(rec["summary"])}; generated songs: '
        + '; '.join(f'{g} {rec[g]["report"]["n_song"]} songs, tokens '
                    f'{rec[g]["report"]["token_length"]}, bars {rec[g]["report"]["bar_count"]}'
                    for g in ('gen-22-11', 'gen-22-04')))

    tok = MusicTokenizer(pitch_kind='midi', model_max_length=2048)
    ds = AugmentedDataset(SongDataset.load(os.path.join(root, 'dataset', 'train.npz')), tok,
                          random_crop=False, dataset_split='test', seed=SEED)
    batch = next(ds.batches(min(16, len(ds)), shuffle=False))
    metric = IkrMetric(tok)
    ikr = {}
    for best in (False, True):
        card = metric.ground_truth_ikr(torch.from_numpy(batch['input_ids']).to(dev),
                                       torch.from_numpy(batch['key_scores']).to(dev), best)
        cpu = metric.ground_truth_ikr(batch['input_ids'], batch['key_scores'], best)
        ikr['best_key_only' if best else 'weighted'] = dict(card=card, cpu=cpu)
        if not 0 < card <= 1 or abs(card - cpu) > 1e-6:
            raise AssertionError(f'ground_truth_ikr card {card} cpu {cpu}')
    rec['ground_truth_ikr'] = ikr
    log(f'[analysis] ground_truth_ikr of {len(batch["input_ids"])} dataset songs: '
        f'{json.dumps(ikr)}')

    mxl = sorted(f for f in os.listdir(os.path.join(root, 'raw')) if f.endswith('.mxl'))
    t0 = time.perf_counter()
    grids = [MelodyGridExtractor()(os.path.join(root, 'raw', f)) for f in mxl[:W2V_SONGS]]
    grid_s = time.perf_counter() - t0
    runs = []
    for device in (dev, torch.device('cpu')):
        pe = PitchEmbedding(device=device, seed=SEED)
        t0 = time.perf_counter()
        pe(grids, epochs=2)                          # ends in a copy to the host
        runs.append((pe, time.perf_counter() - t0))
    (card, card_s), (cpu, cpu_s) = runs
    err = float(np.abs(card.emb_in - cpu.emb_in).max() / np.abs(cpu.emb_in).max())
    rec['pitch_embedding'] = dict(songs=len(grids), grid_ids=sum(map(len, grids)),
                                  grid_seconds=grid_s, card_seconds=card_s, cpu_seconds=cpu_s,
                                  losses_card=card.losses, losses_cpu=cpu.losses, emb_in_err=err)
    log(f'[analysis] melody grids of {len(grids)} rendered .mxl songs: '
        f'{sum(map(len, grids))} ids in {grid_s:.2f} s; PitchEmbedding 2 epochs: card '
        f'{card_s:.2f} s, CPU {cpu_s:.2f} s, losses {card.losses} / {cpu.losses}, emb_in card '
        f'vs CPU {err:.2e} of its max (tol {TOL_W2V})')
    if err > TOL_W2V or not card.losses[-1] < card.losses[0]:
        raise AssertionError(f'PitchEmbedding card vs CPU {err}, losses {card.losses}')
    report['analysis'] = rec


def download_checks(report):
    """Phase 11.4, A.9 on the card's machine, offline: `download` lists the
    registry; an artifact whose one part is a zip built here, served by a
    `file://` URL, is fetched with its sha256 pin, extracted, and refused
    under a wrong pin."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(['download'])
    listed = out.getvalue().splitlines()
    if rc != 0 or len(listed) != len(download.ARTIFACTS):
        raise AssertionError(f'download listed {len(listed)} artifacts, exit {rc}')
    root = os.path.join(RUN_DIR, 'download')
    os.makedirs(root)
    src = os.path.join(root, 'bundle.zip')
    with zipfile.ZipFile(src, 'w') as zf:
        zf.writestr('songs/a.json', json.dumps(dict(score='TimeSig_4/4 </s>')))
    with open(src, 'rb') as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    url = pathlib.Path(src).as_uri()
    reg = {'hf/local': download.Artifact(name='hf/local', urls=(url,), kind='hf',
                                         sha256=(sha,))}
    paths = download.PathRegistry(os.path.join(root, 'base'))
    dest = download.download_artifact('hf/local', paths=paths, registry=reg)
    if not os.path.exists(os.path.join(dest, 'songs', 'a.json')):
        raise AssertionError(f'download_artifact extracted nothing into {dest}')
    try:
        download.fetch(url, os.path.join(root, 'bad.zip'), sha256='0' * 64)
        raise AssertionError('a wrong sha256 pin was accepted')
    except ValueError as e:
        refused = str(e)
    report['download'] = dict(listed=len(listed), dest=os.path.relpath(dest, root), sha256=sha)
    log(f'[download] listed {len(listed)} artifacts; file:// artifact fetched with its sha256 '
        f'pin into {os.path.relpath(dest, root)}; wrong pin refused: {refused[:60]}...')


def analysis_phase(dev, report):
    """Phase 11, each part timed."""
    t0 = time.perf_counter()
    seconds = {}
    for name, fn in (('c1', lambda: c1_checks(dev, report)),
                     ('c2', lambda: c2_checks(dev, report)),
                     ('traced presets', lambda: traced_presets(dev, report)),
                     ('traced C.1 steps', lambda: c1_traces(dev, report)),
                     ('analysis', lambda: analysis_checks(dev, report)),
                     ('download', lambda: download_checks(report))):
        t1 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t1
    report['phase11_seconds'] = dict(seconds, total=time.perf_counter() - t0)
    log(f'[phase 11] seconds: {json.dumps(report["phase11_seconds"])}')


# ------------------------------------- multi-GPU training on the one card (phase 12)
P12_B = 4                                        # (a)'s 22-11 batch (x 1024)
P12_STEPS = 2                                    # (a)'s steps per Trainer
P12_TIMEOUT_S = 300                              # (b)'s two ranks, all three checks
# (b), two ranks at model 2 against one device, f32: the loss and the grad
# norm within TOL_GRAD (relative), each gradient within TOL_GRAD of its
# largest entry (as phase 5 holds the card against the CPU); the parameters
# after the AdamW step within 2 lr of each other (Adam's first step moves
# each entry by lr * g / |g|: an entry whose gradient is near 0 may move
# either way, as in phase 3's resume check); the vocab-sharded head's loss
# within P12_HEAD_LOSS (one f32 logsumexp combined over two blocks)
P12_HEAD_LOSS = 1e-5


def _p12_env(rank: int, world: int, port: int) -> dict:
    """The environment `python -m torch.distributed.run` gives a rank."""
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                MASTER_ADDR='localhost', MASTER_PORT=str(port))


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _p12_step(trainer, flat, batch, dev):
    """`Trainer.train_step`'s parts -- gradients summed over the data ranks,
    the logical norm, AdamW -- from `flat` (full parameters, sharded by the
    Trainer) on this rank's rows -> (metrics, gathered grads, gathered
    params, counts, ms); raises unless the rank holds its share of the heads."""
    params = trainer.shard(params_from_jax(flat, dev))
    heads = params['layers'][0]['attn']['o'].shape[0]
    if heads * trainer.mesh.n_model != trainer.model.cfg.n_head:
        raise AssertionError(f'{heads} local heads of {trainer.model.cfg.n_head} at model '
                             f'{trainer.mesh.n_model}')
    for t in flatten(params).values():
        t.requires_grad_(True)
    state = trainer.opt.init(params)
    i, n = trainer.mesh.batch_index, trainer.mesh.n_batch
    per = len(batch['input_ids']) // n
    rows = tr._to_device({k: v[i * per:(i + 1) * per] for k, v in batch.items()}, dev)

    def step():
        loss, mets, grads = trainer.loss_and_grads(params, rows)
        norm = trainer.opt.norm(grads)
        trainer.opt.step(params, grads, state)
        return dict(loss=float(loss.detach()), grad_norm=float(norm), local_heads=heads), grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (mets, grads), counts = counted(step)
    ms = (time.perf_counter() - t0) * 1e3
    return (mets, flatten(trainer.gather(grads)), flatten(trainer.gather(params)), counts, ms)


def _p12_compare(tag, got, want, lr):
    """(b)'s step check against one device (the constants' comment)."""
    (g_mets, g_grads, g_params), (w_mets, w_grads, w_params) = got, want
    grad_err = {k: rel_max(g_grads[k], w_grads[k]) for k in w_grads}
    worst = max(grad_err, key=grad_err.get)
    p_err = max(float((g_params[k].detach() - w_params[k].detach()).abs().max())
                for k in w_params)
    rec = dict(loss=g_mets['loss'], loss_one_device=w_mets['loss'],
               loss_rel=abs(g_mets['loss'] - w_mets['loss']) / abs(w_mets['loss']),
               grad_norm_rel=abs(g_mets['grad_norm'] - w_mets['grad_norm']) / w_mets['grad_norm'],
               grad_err=grad_err[worst], worst=worst, params_abs_err=p_err, lr=lr)
    if not (rec['loss_rel'] <= TOL_GRAD and rec['grad_norm_rel'] <= TOL_GRAD
            and grad_err[worst] <= TOL_GRAD and p_err <= 2 * lr):
        raise AssertionError(f'[phase 12] {tag}: model 2 vs one device: {rec}')
    return rec


class ShardedBranches(SharedBranches):
    """`SharedBranches` across tensor parallelism: the one-device run records
    its relu and LSH branches at full width, and a rank at model size n
    replays its block of them (its FFN columns; its heads of each [R, B * N,
    T] bucket tensor)."""

    def __init__(self, mesh, n_head):
        super().__init__()
        self.k, self.n, self.n_head = mesh.model_index, mesh.n_model, n_head

    def _share(self, kind, value):
        if self.replaying and self.recorded[kind][0].shape != value.shape:
            full = self.recorded[kind][0]
            if kind == 'relu':
                w = value.shape[-1]
                block = full.narrow(-1, self.k * w, w)
            else:
                R, G, T = full.shape
                hl = self.n_head // self.n
                block = full.reshape(R, G // self.n_head, self.n_head, T).narrow(
                    2, self.k * hl, hl).reshape(R, -1, T)
            self.recorded[kind][0] = block
        return super()._share(kind, value)


def _p12_pair(mesh, one, n_head, run):
    """run(mesh) on one device and then at model 2 on the one device's
    branches -> (one device's result, model 2's result, branches that differ)."""
    with ShardedBranches(mesh, n_head) as shared:
        want = run(one)
        shared.replay()
        got = run(mesh)
    return want, got, {k: f'{shared.differ[k]} of {shared.total[k]}' for k in shared.total}


def _p12_worker(rank: int, port: int, dev_name: str, head_rows, out) -> None:
    """(b): one of two ranks on one card over gloo, mesh (data 1, model 2),
    f32, dropout 0.  Each rank runs each check on one device first (the
    reference, whose relu and LSH branches the model-2 run then takes:
    `ShardedBranches`), then at model 2; rank 0 compares."""
    import torch.distributed as dist
    from musicnlp_tpu_torch.parallel import mesh as mesh_lib
    os.environ.update(_p12_env(rank, 2, port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_lib.init_distributed(backend='gloo', device=dev_name, timeout_s=P12_TIMEOUT_S)
    try:
        mesh = mesh_lib.make_mesh(n_data=1, n_model=2, device=dev_name)
        dev = mesh.device
        if dev.type != 'cuda':
            raise AssertionError(f'rank {rank} runs on {dev}, not the card')
        one = mesh_lib.Mesh(mesh.axis_names, (1, 1), dev)       # the one-device reference
        rec, t0 = dict(rank_device=str(dev)), time.perf_counter()

        def step_check(tag, make_model, tok, rows, args, want_counts):
            batch = next(rows.batches(2, shuffle=False))
            flat = make_model().init_flat(SEED + 121)
            (w_mets, w_grads, w_params, _, w_ms), (mets, grads, params, counts, ms), flips = \
                _p12_pair(mesh, one, make_model().cfg.n_head, lambda m: _p12_step(
                    tr.Trainer(make_model(), tok, rows, None, args=args, mesh=m), flat, batch,
                    dev))
            expect(counts, **want_counts)
            if rank == 0:
                rec[tag] = dict(_p12_compare(tag, (mets, grads, params),
                                             (w_mets, w_grads, w_params), args.learning_rate),
                                counts=counts, step_ms=ms, one_device_step_ms=w_ms,
                                local_heads=mets['local_heads'], branches_differing=flips)
            dist.barrier()
            torch.cuda.empty_cache()

        # TF-XL at the 22-11 widths, 2 x 1024: K1 / K2 on 6 local heads per rank
        tok = MusicTokenizer(pitch_kind='degree', model_max_length=1024)
        cfg = base_config(dtype='float32')
        step_check('tfxl', lambda: TransfoXL(cfg), tok, SyntheticSongs(tok, 2, SEED + 122),
                   train_args(batch_size=2, lr_scheduler_type='constant', seed=SEED),
                   dict(flash_rel_attn_fwd=cfg.n_layer, flash_rel_attn_bwd=cfg.n_layer))

        # the Reformer at the 22-04 widths, 2 x 2048: K3 / K4 on 6 local heads
        rcfg = reformer_config(dtype='float32', dropout=0.0)
        rtok = MusicTokenizer(pitch_kind='midi', model_max_length=rcfg.max_length)
        n = len(rcfg.attn_layers)
        step_check('reformer', lambda: Reformer(rcfg), rtok,
                   SyntheticSongs(rtok, 2, SEED + 124, length=rcfg.max_length, insert_key=False),
                   reformer_train_args(batch_size=2, lr_scheduler_type='constant', seed=SEED),
                   dict(chunked_window_attn_fwd=n, chunked_window_attn_bwd=n))

        # shard_vocab over the 262k table, 22-11 widths at depth 2: model 2 vs model 1
        V = 262144
        vcfg = base_config(vocab_size=V, n_layer=2, dtype='float32', shard_vocab=True,
                           head_chunk=HEAD_CHUNK)
        flat = TransfoXL(vcfg).init_flat(SEED + 125)
        ids = torch.from_numpy(head_rows).to(dev)
        labels = torch.where(ids == tok.pad_token_id, -100, ids)

        def head(m):
            trainer = tr.Trainer(TransfoXL(vcfg), tok, (), mesh=m)
            params = trainer.shard(params_from_jax(flat, dev))
            for t in flatten(params).values():
                t.requires_grad_(True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (loss, mets, grads), counts = counted(
                lambda: trainer.loss_and_grads(params, dict(input_ids=ids, labels=labels)))
            ms = (time.perf_counter() - t1) * 1e3
            return (float(loss.detach()), mets['preds'], flatten(trainer.gather(grads)), counts,
                    ms, tuple(params['embed']['weight'].shape))
        (w_loss, w_preds, w_grads, _, w_ms, _), (loss, preds, grads, counts, ms, held), flips = \
            _p12_pair(mesh, one, vcfg.n_head, head)
        expect(counts, flash_rel_attn_fwd=vcfg.n_layer, flash_rel_attn_bwd=vcfg.n_layer)
        if held != (V // 2, vcfg.d_model):
            raise AssertionError(f'rank {rank} holds embedding rows {held}')
        if rank == 0:
            err = {k: rel_max(grads[k], w_grads[k]) for k in w_grads}
            worst = max(err, key=err.get)
            h = dict(loss=loss, loss_one_device=w_loss, loss_rel=abs(loss - w_loss) / w_loss,
                     preds_equal=bool(torch.equal(preds, w_preds)),
                     preds_in_upper_block=int((preds >= V // 2).sum()),
                     grad_err=err[worst], worst=worst, counts=counts, ms=ms,
                     one_device_ms=w_ms, embed_rows_per_rank=held[0],
                     branches_differing=flips)
            rec['shard_vocab'] = h
            if not (h['loss_rel'] <= P12_HEAD_LOSS and h['preds_equal']
                    and err[worst] <= TOL_GRAD):
                raise AssertionError(f'[phase 12] shard_vocab model 2 vs model 1: {h}')
            rec['seconds'] = time.perf_counter() - t0
            out.put(rec)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def two_ranks_on_one_card(dev, report):
    """Phase 12 (b): two spawned ranks on the one card over gloo (NCCL takes
    one rank per device); any rank's failure fails the phase."""
    import multiprocessing as mp
    import queue as queue_mod
    tok = WordPieceMusicTokenizer.from_file(TABLE_262K, model_max_length=1024)
    ds = StringAugmentedDataset(synthetic_songs(1, 150, SEED + 126), tok, random_crop=False,
                                dataset_split='test', insert_key=True, pitch_shift=True)
    song = next(ds.batches(1, shuffle=False))['input_ids']
    # a song through the table, and seeded ids over all of it, so each rank's
    # block of rows is looked up
    rand = np.random.default_rng(SEED + 127).integers(0, tok.vocab_size, song.shape)
    head_rows = np.concatenate([song, rand]).astype(np.int64)
    ctx = mp.get_context('spawn')
    out = ctx.Queue()
    port = _free_port()
    card = str(torch.device('cuda', torch.cuda.current_device()))    # both ranks' device
    procs = [ctx.Process(target=_p12_worker, args=(r, port, card, head_rows, out))
             for r in range(2)]
    for p in procs:
        p.start()
    rec = None
    deadline = time.perf_counter() + P12_TIMEOUT_S
    try:
        while rec is None:
            if any(p.exitcode not in (None, 0) for p in procs) or \
                    time.perf_counter() > deadline or \
                    (all(p.exitcode == 0 for p in procs) and out.empty()):
                break
            try:
                rec = out.get(timeout=1.0)
            except queue_mod.Empty:
                pass
        if rec is not None:                   # the ranks end after a last barrier
            for p in procs:
                p.join(timeout=max(deadline - time.perf_counter(), 1.0))
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if rec is None or codes != [0, 0]:
        raise AssertionError(f'[phase 12] the two ranks failed: exit codes {codes}')
    log(f'[phase 12] (b) two ranks on one card, gloo, mesh (data 1, model 2), f32: '
        f'{json.dumps(rec)}')
    report['phase12_two_ranks'] = rec


def _p12_param_errs(a, w):
    """(largest error of every leaf but W_r over the largest entry of them
    all, of the W_r leaves over theirs, largest absolute error)."""
    rest = [k for k in w if not k.endswith('attn/r')]
    w_r = [k for k in w if k.endswith('attn/r')]

    def err(keys):
        scale = max(float(w[k].abs().max()) for k in keys)
        return max(float((a[k] - w[k]).abs().max()) for k in keys) / scale
    return err(rest), err(w_r), max(float((a[k] - w[k]).abs().max()) for k in w)


def world_of_one(dev, report):
    """Phase 12 (a): a world of one process on NCCL, mesh (1, 1), against
    the mesh-free Trainer: 22-11 widths, bf16, dropout 0.1, B 4 x 1024, 2
    steps from one seed; then a traced step (12 K1 / K2 by kernel name).
    K2 sums W_r's gradient with atomics, in an order that changes from run to
    run: after step 1 every other parameter is held to 1e-4 of the largest
    (it is computed alike), W_r to TOL_W_R; after step 2, whose forward reads
    the moved W_r, every entry within 2 * (lr summed over the steps), phase
    3's resume limit, and W_r within TOL_W_R."""
    import torch.distributed as dist
    from musicnlp_tpu_torch.parallel import mesh as mesh_lib
    tok = MusicTokenizer(pitch_kind='degree', model_max_length=1024)
    cfg = base_config(dropout=0.1)
    rows = SyntheticSongs(tok, P12_B * P12_STEPS, SEED + 120)
    flat = TransfoXL(cfg).init_flat(SEED)
    batches = [tr._to_device(b, dev) for b in rows.batches(P12_B, seed=1)]
    args = train_args(batch_size=P12_B, lr_scheduler_type='constant', seed=SEED)

    def run(trainer):
        params = params_from_jax(flat, dev)
        for t in flatten(params).values():
            t.requires_grad_(True)
        state = trainer.opt.init(params)
        losses, ms, after = [], [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(params, state, b)['loss']))
            ms.append((time.perf_counter() - t0) * 1e3)
            after.append({k: t.detach().clone() for k, t in flatten(params).items()})
        return params, state, losses, ms, after

    free = tr.Trainer(TransfoXL(cfg), tok, rows, None, args=args)
    _, _, l_free, ms_free, after_free = run(free)
    saved = {k: os.environ.get(k) for k in _p12_env(0, 1, 0)}
    os.environ.update(_p12_env(0, 1, _free_port()))
    try:
        world = mesh_lib.init_distributed()
        if world != 1 or dist.get_backend() != 'nccl':
            raise AssertionError(f'init_distributed: world {world}, {dist.get_backend()}')
        mesh = mesh_lib.make_mesh()
        one = tr.Trainer(TransfoXL(cfg), tok, rows, None, args=args, mesh=mesh)
        p_one, s_one, l_one, ms_one, after_one = run(one)
        b = batches[0]
        counts, kernels, traced_ms = traced_step(os.path.join(RUN_DIR, 'p12'),
                                                 lambda: one.train_step(p_one, s_one, b))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    errs = [_p12_param_errs(a, w) for a, w in zip(after_one, after_free)]
    lr_sum = args.learning_rate * P12_STEPS
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(l_one, l_free))
    names = named(kernels, 'k1_tc', 'k2_dkdv_tc', 'k2_dq_tc')
    rec = dict(mesh=mesh.shape, backend='nccl', losses=l_one, losses_mesh_free=l_free,
               loss_rel=loss_rel, step1=dict(zip(('params_err', 'w_r_err', 'abs_err'), errs[0])),
               step2=dict(zip(('params_err', 'w_r_err', 'abs_err'), errs[-1])),
               lr_sum=lr_sum, step_ms=ms_one, step_ms_mesh_free=ms_free, counts=counts,
               traced_kernels=names, traced_step_ms=traced_ms)
    log(f'[phase 12] (a) world of one on NCCL vs the mesh-free Trainer, 22-11 bf16 '
        f'{P12_B} x 1024, {P12_STEPS} steps: losses {l_one} vs {l_free} (rel {loss_rel:.2e}); '
        f'params after step 1 / 2 (rest of max, W_r of max, largest abs): {errs}; step ms '
        f'{[round(x, 1) for x in ms_one]} vs mesh-free {[round(x, 1) for x in ms_free]}; '
        f'traced step {names}, counts {counts}')
    expect(counts, flash_rel_attn_fwd=cfg.n_layer, flash_rel_attn_bwd=cfg.n_layer)
    if not (loss_rel <= 1e-4 and errs[0][0] <= 1e-4 and all(e[1] <= TOL_W_R for e in errs)
            and errs[-1][2] <= 2 * lr_sum and set(names.values()) == {cfg.n_layer}):
        raise AssertionError(f'[phase 12] (a) the world of one differs: {rec}')
    report['phase12_world_of_one'] = rec


def multi_gpu_phase(dev, report):
    """Phase 12, each part timed."""
    t0 = time.perf_counter()
    seconds = {}
    for name, fn in (('world of one', lambda: world_of_one(dev, report)),
                     ('two ranks', lambda: two_ranks_on_one_card(dev, report))):
        t1 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    report['phase12_seconds'] = dict(seconds, total=time.perf_counter() - t0)
    log(f'[phase 12] seconds: {json.dumps(report["phase12_seconds"])}')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    t_start = time.perf_counter()
    report = dict(started=time.strftime('%Y-%m-%d %H:%M:%S'))

    # 1. device and build
    card = gpu_name_and_power()
    log(f'[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | '
        f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    t0 = time.perf_counter()
    built = build_all()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        ptx = ' '.join(l.strip() for l in info['ptxas'].splitlines() if 'registers' in l)
        log(f'[build] {name}: {info["seconds"]:.1f} s cached={info["cached"]} {ptx}')
    log(f'[build] all kernels, in parallel: {build_s:.1f} s')
    report.update(card=card, build_seconds=build_s)
    tensor_core_check(report)
    kernel_resources(report, built)

    # 2. K1 and K2 against their plain versions on the card
    k1 = [
        k1_case(dev, 'base-bf16', torch.bfloat16, 8, 12, 1024, 0, 64, 1024, 0, 0, 1, True),
        k1_case(dev, 'base-f32', torch.float32, 8, 12, 1024, 0, 64, 1024, 0, 0, 2, True),
        k1_case(dev, 'train-bf16', torch.bfloat16, 21, 12, 1024, 0, 64, 1024, 0, 0, 7, True),
        k1_case(dev, 'memory-window-bf16', torch.bfloat16, 8, 12, 1024, 512, 64, 96, 300, 512,
                3, False),
        k1_case(dev, 'memory-window-f32', torch.float32, 2, 12, 1024, 512, 64, 96, 300, 512,
                4, False),
        k1_case(dev, 'debug-h16-ragged', torch.float32, 4, 8, 333, 64, 16, 64, 40, 0, 5, False),
        k1_case(dev, 'debug-h16-ragged-bf16', torch.bfloat16, 4, 8, 333, 64, 16, 64, 64, 0, 6,
                False),
        # recipe 22-12 (TF-XL small, max_length 2048, mem_len 1024, full memory) at
        # B 4: the plain version's [BN, T, T+S] f32 scores stay near 1.3 GB
        k1_case(dev, '22-12-bf16', torch.bfloat16, 4, 8, 2048, 1024, 64, 1024, 1024, 0, 8,
                True),
        # HF-imported TF-XL (phase 10): same_length makes every query attend a
        # mem_len-wide window, 512 at T 1024, with or without a 512 memory
        k1_case(dev, 'hf-window-bf16', torch.bfloat16, 8, 12, 1024, 0, 64, 1024, 0, 512, 9,
                True),
        k1_case(dev, 'hf-window-mem-bf16', torch.bfloat16, 8, 12, 1024, 512, 64, 1024, 512,
                512, 10, True),
        k1_case(dev, 'hf-window-mem-f32', torch.float32, 2, 12, 1024, 512, 64, 1024, 512, 512,
                11, False),
        # C.1 (phase 11's shapes): head dim 128 (d_model 1024, 8 heads, 2 x
        # 1024; bf16 on k1_tc's two-warp groups, f32 on the slab kernel's two
        # slabs of 64), and f16 at the 22-11 widths
        k1_case(dev, 'd128-bf16', torch.bfloat16, 2, 8, 1024, 0, 128, 1024, 0, 0, 12, True),
        k1_case(dev, 'd128-f32', torch.float32, 2, 8, 1024, 0, 128, 1024, 0, 0, 13, True),
        k1_case(dev, 'f16', torch.float16, 2, 12, 1024, 0, 64, 1024, 0, 0, 14, True),
        k1_case(dev, 'd128-memory-window-f16', torch.float16, 2, 8, 1000, 512, 128, 96, 300,
                512, 15, False),
        # the 22-11 batch at d_model 768 with head dim 128 (B 21 x 6 heads), K2's
        # d128-train-bf16 counterpart
        k1_case(dev, 'd128-train-bf16', torch.bfloat16, 21, 6, 1024, 0, 128, 1024, 0, 0, 16,
                True),
        # C.2 (phase 11's head dim 256: d_model 1024, 4 heads, 2 x 1024): the
        # slab kernel in every dtype, and once at 384 (six slabs of 64)
        k1_case(dev, 'd256-bf16', torch.bfloat16, 2, 4, 1024, 0, 256, 1024, 0, 0, 17, True),
        k1_case(dev, 'd256-f16', torch.float16, 2, 4, 1024, 0, 256, 1024, 0, 0, 18, True),
        k1_case(dev, 'd256-f32', torch.float32, 2, 4, 1024, 0, 256, 1024, 0, 0, 19, True),
        k1_case(dev, 'd256-memory-window-f32', torch.float32, 2, 4, 1000, 512, 256, 96, 300,
                512, 20, False),
        k1_case(dev, 'd384-bf16', torch.bfloat16, 2, 4, 1024, 0, 384, 1024, 0, 0, 21, True),
        k1_case(dev, 'd384-f32', torch.float32, 2, 4, 1024, 0, 384, 1024, 0, 0, 22, True),
    ]
    k2 = [
        k2_case(dev, 'train-bf16', torch.bfloat16, 21, 12, 1024, 0, 64, 1024, 0, 0, 21, True),
        k2_case(dev, 'train-f32', torch.float32, 21, 12, 1024, 0, 64, 1024, 0, 0, 22, True),
        k2_case(dev, 'memory-window-bf16', torch.bfloat16, 8, 12, 1024, 512, 64, 96, 300, 512,
                23, False),
        k2_case(dev, 'memory-window-f32', torch.float32, 2, 12, 1024, 512, 64, 96, 300, 512,
                24, False),
        k2_case(dev, 'debug-h16-ragged', torch.float32, 4, 8, 333, 64, 16, 64, 40, 0, 25, False),
        k2_case(dev, 'debug-h16-ragged-bf16', torch.bfloat16, 4, 8, 333, 64, 16, 64, 64, 0, 26,
                False),
        k2_case(dev, '22-12-bf16', torch.bfloat16, 4, 8, 2048, 1024, 64, 1024, 1024, 0, 27,
                False),
        k2_case(dev, 'hf-window-train-bf16', torch.bfloat16, 21, 12, 1024, 0, 64, 1024, 0, 512,
                28, True),
        k2_case(dev, 'hf-window-mem-bf16', torch.bfloat16, 8, 12, 1024, 512, 64, 1024, 512, 512,
                29, False),
        k2_case(dev, 'hf-window-mem-f32', torch.float32, 2, 12, 1024, 512, 64, 1024, 512, 512,
                30, False),
        k2_case(dev, 'd128-bf16', torch.bfloat16, 2, 8, 1024, 0, 128, 1024, 0, 0, 31, True),
        k2_case(dev, 'd128-f32', torch.float32, 2, 8, 1024, 0, 128, 1024, 0, 0, 32, True),
        k2_case(dev, 'f16', torch.float16, 2, 12, 1024, 0, 64, 1024, 0, 0, 33, True),
        k2_case(dev, 'd128-memory-window-f16', torch.float16, 2, 8, 1000, 512, 128, 96, 300,
                512, 34, True),
        # the 22-11 batch at d_model 768 with head dim 128 (B 21 x 6 heads)
        k2_case(dev, 'd128-train-bf16', torch.bfloat16, 21, 6, 1024, 0, 128, 1024, 0, 0, 35,
                True),
        # C.2: head dim 256 in every dtype, and once at 384
        k2_case(dev, 'd256-bf16', torch.bfloat16, 2, 4, 1024, 0, 256, 1024, 0, 0, 36, True),
        k2_case(dev, 'd256-f16', torch.float16, 2, 4, 1024, 0, 256, 1024, 0, 0, 37, True),
        k2_case(dev, 'd256-f32', torch.float32, 2, 4, 1024, 0, 256, 1024, 0, 0, 38, True),
        k2_case(dev, 'd256-memory-window-f32', torch.float32, 2, 4, 1000, 512, 256, 96, 300,
                512, 39, False),
        k2_case(dev, 'd384-bf16', torch.bfloat16, 2, 4, 1024, 0, 384, 1024, 0, 0, 40, True),
    ]
    k1_ms = {c['case']: c.get('ms') for c in k1}
    k2_ms = {c['case']: c.get('ms') for c in k2}
    log(f'[k1/k2] windowed (HF same_length) vs full causal, bf16 ms: K1 B 8 '
        f'{k1_ms["hf-window-bf16"]:.4f} vs {k1_ms["base-bf16"]:.4f}, with a 512 memory '
        f'{k1_ms["hf-window-mem-bf16"]:.4f}; K2 B 21 {k2_ms["hf-window-train-bf16"]:.4f} vs '
        f'{k2_ms["train-bf16"]:.4f}')
    report.update(k1_cases=k1, k2_cases=k2)

    # 2b. K3 and K4 against their plain versions on the card: the 22-04
    # shapes (training batch 32: local G = 32 x 12, LSH G = 32 x 12 x 2)
    k3 = [
        k3_case(dev, 'lsh-bf16', torch.bfloat16, 768, 2048, 64, 64, True, 0, 31),
        k3_case(dev, 'lsh-f32', torch.float32, 768, 2048, 64, 64, True, 0, 32),
        k3_case(dev, 'local-bf16', torch.bfloat16, 384, 2048, 64, 64, False, 0, 33),
        k3_case(dev, 'local-f32', torch.float32, 384, 2048, 64, 64, False, 0, 34),
        k3_case(dev, 'local-padded-bf16', torch.bfloat16, 384, 2048, 64, 64, False, 300, 35),
        k3_case(dev, 'lsh-padded-f32', torch.float32, 96, 2048, 64, 64, True, 300, 36),
        k3_case(dev, 'd32-chunk32-single-block', torch.float32, 8, 32, 32, 32, True, 4, 37),
        k3_case(dev, 'd16-chunk32-padded-bf16', torch.bfloat16, 48, 512, 16, 32, True, 40, 38),
        k3_case(dev, 'd32-chunk32-padded-bf16', torch.bfloat16, 48, 512, 32, 32, True, 40, 39),
        # C.1's shapes: phase 11's local layer at chunk 128 (2 x 12 heads)
        # (f32 k3_slab, bf16 the tiled walk k3_union_tc), chunk 128 at D 128,
        # the LSH shape in f16 (k3_tc<__half>), chunk 16 padded
        k3_case(dev, 'chunk128-f32', torch.float32, 24, 2048, 64, 128, False, 0, 131),
        k3_case(dev, 'chunk128-bf16', torch.bfloat16, 24, 2048, 64, 128, False, 0, 132),
        k3_case(dev, 'chunk128-d128-bf16', torch.bfloat16, 16, 2048, 128, 128, True, 40, 133),
        k3_case(dev, 'lsh-f16', torch.float16, 48, 2048, 64, 64, True, 0, 134),
        k3_case(dev, 'chunk16-padded-f32', torch.float32, 8, 480, 32, 16, True, 9, 135),
        # C.2: head dim 256 (phase 11's Reformer: 12 heads; the LSH layer's
        # two hashes) on the slab walk in every dtype, LSH with pads and local
        k3_case(dev, 'd256-lsh-bf16', torch.bfloat16, 48, 2048, 256, 64, True, 40, 136),
        k3_case(dev, 'd256-lsh-f16', torch.float16, 48, 2048, 256, 64, True, 40, 137),
        k3_case(dev, 'd256-lsh-f32', torch.float32, 48, 2048, 256, 64, True, 40, 138),
        k3_case(dev, 'd256-local-bf16', torch.bfloat16, 24, 2048, 256, 64, False, 0, 139),
        k3_case(dev, 'd256-local-f32', torch.float32, 24, 2048, 256, 64, False, 0, 140),
    ]
    k4 = [
        k4_case(dev, 'lsh-bf16', torch.bfloat16, 768, 2048, 64, 64, True, 0, 41),
        k4_case(dev, 'lsh-f32', torch.float32, 768, 2048, 64, 64, True, 0, 42),
        k4_case(dev, 'local-bf16', torch.bfloat16, 384, 2048, 64, 64, False, 0, 43),
        k4_case(dev, 'local-padded-f32', torch.float32, 96, 2048, 64, 64, False, 300, 44),
        k4_case(dev, 'd32-chunk32-single-block', torch.float32, 8, 32, 32, 32, True, 4, 45),
        k4_case(dev, 'd16-chunk32-padded-bf16', torch.bfloat16, 48, 512, 16, 32, True, 40, 46),
        k4_case(dev, 'chunk128-f32', torch.float32, 24, 2048, 64, 128, False, 0, 141),
        k4_case(dev, 'chunk128-bf16', torch.bfloat16, 24, 2048, 64, 128, False, 0, 142),
        k4_case(dev, 'chunk128-d128-bf16', torch.bfloat16, 16, 2048, 128, 128, True, 40, 143),
        k4_case(dev, 'chunk128-d128-f32', torch.float32, 16, 2048, 128, 128, True, 40, 151),
        k4_case(dev, 'lsh-f16', torch.float16, 48, 2048, 64, 64, True, 0, 144),
        k4_case(dev, 'chunk16-padded-f32', torch.float32, 8, 480, 32, 16, True, 9, 145),
        # ragged 64-row tiles over several chunks on the tensor cores
        k4_case(dev, 'chunk16-padded-f16', torch.float16, 8, 480, 32, 16, True, 9, 146),
        k4_case(dev, 'd256-lsh-bf16', torch.bfloat16, 48, 2048, 256, 64, True, 40, 147),
        k4_case(dev, 'd256-lsh-f16', torch.float16, 48, 2048, 256, 64, True, 40, 148),
        k4_case(dev, 'd256-lsh-f32', torch.float32, 48, 2048, 256, 64, True, 40, 149),
        k4_case(dev, 'd256-local-bf16', torch.bfloat16, 24, 2048, 256, 64, False, 0, 150),
    ]
    report.update(k3_cases=k3, k4_cases=k4)

    # 2c. the dense layers' epilogue (bias, relu, one rounding) against its
    # plain version on the card
    bias_act_cases = bias_act_phase(dev, report)

    # 3. the training path, counted
    tok = MusicTokenizer(pitch_kind='degree', model_max_length=1024)
    train_launches = training_path(dev, tok, report)

    # 4. the scoring and generation paths, counted
    cfg = base_config()
    model = TransfoXL(cfg)
    params = params_from_jax(model.init_flat(SEED), dev)
    ikr = IkrMetric(tok, mode='ins-key')
    ids, labels = score_inputs(cfg.vocab_size, 8, 1024, SEED + 1, dev)

    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    layers.LAUNCHES['bias_act'] = 0
    mets = score_batch(model, params, ids, labels, ikr)
    torch.cuda.synchronize()
    per_forward = fa.LAUNCHES['flash_rel_attn_fwd']
    bias_act_per_forward = layers.LAUNCHES['bias_act']
    mets = {k: float(v) for k, v in mets.items()}
    log(f'[score] base bf16 8x1024: {json.dumps(mets)} K1 launches {per_forward}, '
        f'bias_act {bias_act_per_forward}')
    if per_forward != cfg.n_layer or fa.LAUNCHES['flash_rel_attn_bwd']:
        raise AssertionError(f'K1 launched {per_forward} times in one forward, '
                             f'expected {cfg.n_layer} (and no K2): {fa.LAUNCHES}')
    if bias_act_per_forward != 2 * cfg.n_layer:
        raise AssertionError(f'bias_act launched {bias_act_per_forward} times in one forward, '
                             f'expected {2 * cfg.n_layer} (two dense layers a FFN)')
    if not all(math.isfinite(v) for v in mets.values()) or \
            abs(mets['loss'] - math.log(cfg.vocab_size)) > 0.5 or not 0 <= mets['ikr'] <= 1:
        raise AssertionError(f'scoring metrics out of range: {mets}')

    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    gen_rec = {}
    for quant in (None, 'int8'):
        qmodel = TransfoXL(dataclasses.replace(cfg, decode_cache_quant=quant))
        texts, lens, new_tok, dt = run_generation(qmodel, params, tok, 4, 'sample', SEED,
                                                  top_k=8)
        label = quant or 'bf16'
        gen_rec[label] = dict(lengths=lens, new_tokens=new_tok, seconds=dt,
                              decode_tok_per_s=new_tok / dt, sample=texts[0][:160])
        log(f'[generate] sample top_k=8, {label} cache, 4 requests: lengths {lens}, '
            f'{new_tok / dt:.1f} decode tok/s ({dt:.1f} s)')

    # greedy with early exit: raise </s>'s bias so the song ends; the early-exit
    # output must equal the full-length run's
    eos_params = dict(params, out_bias=params['out_bias'].clone())
    eos_params['out_bias'][tok.eos_token_id] = 5.0
    (g_fast,), lens_fast, _, dt_fast = run_generation(model, eos_params, tok, 1, 'greedy', SEED,
                                                      early_exit_chunk=128)
    (g_full,), _, _, dt_full = run_generation(model, eos_params, tok, 1, 'greedy', SEED,
                                              early_exit_chunk=0)
    if g_fast != g_full or not g_fast.endswith('</s>'):
        raise AssertionError(f'early exit changed the greedy output: {g_fast!r} vs {g_full!r}')
    gen_rec['greedy_early_exit'] = dict(length=lens_fast[0], seconds=dt_fast,
                                        full_run_seconds=dt_full)
    log(f'[generate] greedy, early exit: length {lens_fast[0]}, {dt_fast:.2f} s '
        f'(all 1023 steps: {dt_full:.2f} s), outputs identical')
    gen_launches = dict(fa.LAUNCHES)
    if gen_launches['flash_rel_attn_fwd'] or gen_launches['flash_rel_attn_bwd']:
        raise AssertionError(f'generation runs the plain decode step, no kernel: {gen_launches}')
    report.update(score=mets, generate=gen_rec, train_path_launches=train_launches,
                  score_path_launches=per_forward, generate_path_launches=gen_launches)

    # 5. f32 on the card vs the port's CPU f32 run, and throughput
    cfg32 = base_config(dtype='float32')
    m32, m32_cpu = TransfoXL(cfg32), TransfoXL(cfg32, device='cpu')
    flat = m32.init_flat(SEED)
    p32, p32_cpu = params_from_jax(flat, dev), params_from_jax(flat, 'cpu')
    saved = fa.LAUNCHES['flash_rel_attn_fwd']
    with torch.no_grad():
        l_card, _ = m32.loss(p32, ids[:1], labels[:1])
        l_cpu, _ = m32_cpu.loss(p32_cpu, ids[:1].cpu(), labels[:1].cpu())
    if fa.LAUNCHES['flash_rel_attn_fwd'] - saved != cfg32.n_layer:
        raise AssertionError('the f32 forward on the card did not run through K1')
    rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    log(f'[score] f32 loss B=1: card {float(l_card):.7f} cpu {float(l_cpu):.7f} rel {rel:.2e}')
    if rel > 1e-4:
        raise AssertionError(f'card and CPU f32 losses disagree: {rel}')
    del m32, p32, p32_cpu
    card_vs_cpu_grads(dev, report)

    fa.LAUNCHES['flash_rel_attn_fwd'] = 0
    n_iter = 5
    ms = time_ms(lambda: score_batch(model, params, ids, labels, ikr), iters=n_iter, warmup=1)
    if fa.LAUNCHES['flash_rel_attn_fwd'] != cfg.n_layer * (n_iter + 1):
        raise AssertionError('K1 launches per forward changed during the timing loop')
    score_tps = ids.numel() / (ms / 1e3)
    log(f'[score] throughput base bf16 8x1024: {ms:.2f} ms/batch, {score_tps:.0f} tok/s')
    score_prof = profile(lambda: score_batch(model, params, ids, labels, ikr))
    dparams = model.compute_params(params)
    state = model.init_decode_state(4)
    tok_in = ids[:4, 0]
    for _ in range(4):                            # warm the decode path
        _, state = model.decode_step(dparams, tok_in, state)

    def decode8():
        nonlocal state
        for _ in range(8):
            _, state = model.decode_step(dparams, tok_in, state)
    decode_prof = profile(decode8)
    for label, prof in (('score batch', score_prof), ('8 decode steps', decode_prof)):
        top = ', '.join(f'{r["name"][:40]} {r["device_ms"]:.3f}' for r in prof['top'][:5])
        log(f'[profile] {label}: wall {prof["wall_ms"]:.2f} ms, device busy '
            f'{prof["device_ms"]:.2f} ms ({prof["busy_share"]:.1%}); top: {top}')
    report.update(profile_score=score_prof, profile_decode=decode_prof)
    report.update(f32_loss_card=float(l_card), f32_loss_cpu=float(l_cpu), f32_rel=rel,
                  score_ms=ms, score_tok_per_s=score_tps)
    del model, params, dparams, state
    torch.cuda.empty_cache()

    # 6. the Reformer (22-04): training, scoring and generation, each counted,
    # and the card against the port's CPU run in f32
    rtok = MusicTokenizer(pitch_kind='midi', model_max_length=2048)
    reformer_train_launches = reformer_training_path(dev, rtok, report)
    reformer_card_vs_cpu(dev, report)
    reformer_score_and_generate(dev, rtok, report)
    torch.cuda.empty_cache()

    # 7. K5 and K6, and the roofline tool with phase 2b's K3 LSH time (bf16)
    roofline_rows, roofline_launches = roofline_phase(dev, k3[0]['ms'], report)

    # 8. the user's path through the command line
    cli_path(dev, report)

    # 9. A.6's plain attention dispatch, the 262k head, the learned
    # tokenizers through the command line, the adaptive head
    learned_tokenizer_phase(dev, report)

    # 10. HF checkpoints of both families through the entry points, remat_attn
    # and remat, the 'bounded' and streamed LSH decode
    hf_interop_phase(dev, report)

    # 11. C.1's widened kernels through the models, the presets traced, the
    # analysis modules on phase 8's run, the download
    analysis_phase(dev, report)

    # 12. multi-GPU training on the one card: a world of one on NCCL, two
    # ranks at model 2 over gloo (TF-XL, the Reformer, the 262k sharded head)
    multi_gpu_phase(dev, report)
    report.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                  seconds=time.perf_counter() - t_start)
    shutil.rmtree(RUN_DIR, ignore_errors=True)

    def row(name, case, replaces, launches):
        return dict(name=name, route='cuda', source=f'musicnlp_tpu_torch/csrc/{name}.cu',
                    replaces=replaces, launches=launches, max_abs_err=case['max_abs_err'],
                    ms=case['ms'], plain_ms=case['plain_ms'], bound_ms=case['bound_ms'],
                    bound_by=case['bound_by'], library_ms=case['library_ms'])
    # times at the training shapes (TF-XL 21 x 1024, Reformer LSH 32 x 2048,
    # bf16); launches of each model's training path
    kernels = [row('flash_rel_attn_fwd', k1[2], K1_REPLACES,
                   train_launches['flash_rel_attn_fwd']),
               row('flash_rel_attn_bwd', k2[0], K2_REPLACES,
                   train_launches['flash_rel_attn_bwd']),
               row('chunked_window_attn_fwd', k3[0], K3_REPLACES,
                   reformer_train_launches['chunked_window_attn_fwd']),
               row('chunked_window_attn_bwd', k4[0], K4_REPLACES,
                   reformer_train_launches['chunked_window_attn_bwd']),
               # K5 / K6: one call of K = 1024 passes; launches of the roofline tool
               row('mask_chain', roofline_rows['mask_chain'], K5_REPLACES,
                   roofline_launches['mask_chain']),
               row('muladd_chain', roofline_rows['muladd_chain'], K6_REPLACES,
                   roofline_launches['muladd_chain']),
               # the FFN's w1 epilogue at scoring's 65,536 tokens, bf16, relu;
               # launches of one 12-layer forward (phase 4)
               row('bias_act', bias_act_cases[0], BIAS_ACT_REPLACES, bias_act_per_forward)]
    report['kernels'] = kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
        json.dump(report, f, indent=1)
    log(f'[done] {report["seconds"]:.1f} s')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
