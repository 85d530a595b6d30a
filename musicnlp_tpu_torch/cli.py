"""Command-line interface of the port: `python -m musicnlp_tpu_torch <command>`
(console script `musicnlp-tpu-torch`).

Counterpart of `musicnlp_tpu/cli.py`, with its flags, over the port's own
data pipeline, Trainer and generator:

    python -m musicnlp_tpu_torch dataset  combined.json --out dataset/ [--pitch-kind step]
    python -m musicnlp_tpu_torch train    --dataset dataset/ --out models/run1 \\
                                          [--recipe 22-11 | --model transf-xl --size base]
    python -m musicnlp_tpu_torch generate --model-dir models/run1 --n 4 \\
                                          [--strategy sample --top-k 8] [--key CMajor]

`train` and `generate` run on CUDA; `--device cpu` asks for the CPU, and
without CUDA and without it the command exits non-zero with the device
resolver's error.  `extract` and `download` come with a later slice; the beam
and contrastive strategies (slice A.3) and the learned tokenizer schemes
(slice A.4) exit non-zero with their `NotImplementedError`; their own flags
(`--num-beams`, `--penalty-alpha`, `--tokenizer-path`, ...) come with those
slices, so argparse refuses them until then.  Heavy imports
stay inside each command, so `--help` is instant.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional


def _device(a):
    """The command's device; without CUDA (and no `--device cpu`) exits non-zero
    with the resolver's error."""
    from musicnlp_tpu_torch import resolve_device
    try:
        return resolve_device(a.device)
    except RuntimeError as e:
        raise SystemExit(f'error: {e}') from e


def _cmd_dataset(a) -> int:
    from musicnlp_tpu_torch.preprocess.music_export import combine_saved_songs, json2dataset
    if os.path.isdir(a.songs):
        combined = combine_saved_songs(sorted(glob.glob(os.path.join(a.songs, '*.json'))))
    else:
        with open(a.songs) as f:
            combined = json.load(f)
    paths = json2dataset(combined, a.out, test_frac=a.test_frac, pitch_kind=a.pitch_kind)
    print(json.dumps(paths))
    return 0


def _cmd_train(a) -> int:
    if a.tokenizer_scheme != 'vanilla':
        raise NotImplementedError(f'tokenizer scheme {a.tokenizer_scheme!r} comes with the '
                                  f'learned-tokenizer slice (A.4)')
    dev = _device(a)
    from musicnlp_tpu_torch.preprocess.dataset import AugmentedDataset, SongDataset
    from musicnlp_tpu_torch.trainer.train import (
        TrainArgs, Trainer, get_model_n_tokenizer, setup_recipe,
    )
    train_sd = SongDataset.load(os.path.join(a.dataset, 'train.npz'))
    test_path = os.path.join(a.dataset, 'test.npz')
    eval_sd = SongDataset.load(test_path) if os.path.exists(test_path) else None
    overrides = {}
    if a.epochs is not None:
        overrides['num_train_epochs'] = a.epochs
    if a.batch_size is not None:
        overrides['batch_size'] = a.batch_size
    if a.recipe:
        trainer = setup_recipe(a.recipe, train_sd, eval_datasets=eval_sd, out_dir=a.out,
                               train_args=overrides, device=dev)
    else:
        model, tok = get_model_n_tokenizer(a.model, a.size, pitch_kind=a.pitch_kind,
                                           max_length=a.max_length, device=dev)
        insert_key = a.insert_key
        if tok.pitch_kind == 'degree' and not insert_key:
            # degree pitch ids are key-conditioned; without the shift the
            # step-kind corpus would index garbage degree tokens
            print('note: degree pitch kind requires key augmentation; '
                  'enabling --insert-key', file=sys.stderr)
            insert_key = True
        aug = dict(insert_key=insert_key, pitch_shift=insert_key, channel_mixup=a.channel_mixup)
        train_ds = AugmentedDataset(train_sd, tok, dataset_split='train', **aug)
        eval_ds = (AugmentedDataset(eval_sd, tok, random_crop=False, dataset_split='test', **aug)
                   if eval_sd is not None else None)
        args = TrainArgs.from_preset(a.model, a.size, **overrides)
        trainer = Trainer(model, tok, train_ds, eval_ds, args=args, out_dir=a.out)
    summary = trainer.train()
    print(json.dumps(dict(out_dir=trainer.out_dir, **{
        k: v for k, v in (summary or {}).items() if isinstance(v, (int, float, str))})))
    return 0


def _cmd_generate(a) -> int:
    if a.strategy in ('beam', 'contrastive'):
        raise NotImplementedError(f'strategy {a.strategy!r} comes with slice A.3 (beam and '
                                  f'contrastive search)')
    dev = _device(a)
    import dataclasses
    from musicnlp_tpu_torch.trainer.eval import MusicGenerator, load_trained
    model, params, tok = load_trained(a.model_dir, device=dev)
    if a.kv_cache != 'bf16' and hasattr(model.cfg, 'decode_cache_quant'):
        model = type(model)(dataclasses.replace(model.cfg, decode_cache_quant=a.kv_cache),
                            device=dev)
    gen = MusicGenerator(model, tok, params, augment_key=a.key is not None, out_dir=a.out)
    strategy_args = {k: v for k, v in dict(top_k=a.top_k, top_p=a.top_p,
                                           temperature=a.temperature, typical_p=a.typical_p,
                                           repetition_penalty=a.repetition_penalty).items()
                     if v is not None}
    prompt_args = {}
    if a.key:
        prompt_args['key'] = a.key
    mode = 'unconditional'
    if a.condition_on:
        mode = 'conditional'
        prompt_args['songs'] = [a.condition_on] * a.n
        prompt_args['n_bar'] = a.n_bar
    outs = gen(mode=mode, strategy=a.strategy, n_song=a.n, seed=a.seed,
               max_length=a.max_length, prompt_args=prompt_args, repair=a.repair,
               **strategy_args)
    for o in outs:
        print(o.get('mxl') or o['text'][:80])
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='musicnlp_tpu_torch',
        description='symbolic music generation on PyTorch / CUDA (the port of musicnlp_tpu)')
    sub = p.add_subparsers(dest='command', required=True)

    d = sub.add_parser('dataset', help='combined JSON (or shard dir) -> columnar npz dataset')
    d.add_argument('songs', help='combined.json or a dir of per-song JSONs')
    d.add_argument('--out', required=True)
    d.add_argument('--test-frac', type=float, default=0.02)
    d.add_argument('--pitch-kind', choices=['midi', 'step', 'degree'], default='step')
    d.set_defaults(fn=_cmd_dataset)

    t = sub.add_parser('train', help='train a model on an npz dataset')
    t.add_argument('--dataset', required=True, help='dir with train.npz[/test.npz]')
    t.add_argument('--out', required=True, help='checkpoint/output dir')
    t.add_argument('--recipe', choices=['22-04', '22-11', '22-12'],
                   help='named reference recipe (overrides model/size flags)')
    t.add_argument('--model', choices=['transf-xl', 'reformer'], default='transf-xl')
    t.add_argument('--size', default='base',
                   choices=['debug', 'debug-large', 'tiny', 'small', 'base', 'large'])
    t.add_argument('--pitch-kind', choices=['midi', 'step', 'degree'], default='degree')
    t.add_argument('--max-length', type=int, default=None)
    t.add_argument('--epochs', type=int, default=None)
    t.add_argument('--batch-size', type=int, default=None)
    t.add_argument('--insert-key', action='store_true',
                   help='key-insert + degree pitch-shift augmentation')
    t.add_argument('--channel-mixup', action='store_true')
    t.add_argument('--tokenizer-scheme', default='vanilla',
                   choices=['vanilla', 'wordpiece', 'pairmerge'],
                   help='only vanilla until the learned-tokenizer slice')
    t.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    t.set_defaults(fn=_cmd_train)

    g = sub.add_parser('generate', help='sample songs from a trained model')
    g.add_argument('--model-dir', required=True, help="a train run's --out dir")
    g.add_argument('--out', default='generated', help='.mxl/.mid/.json output dir')
    g.add_argument('--n', type=int, default=1)
    g.add_argument('--strategy', default='sample',
                   choices=['greedy', 'sample', 'beam', 'contrastive'])
    g.add_argument('--top-k', type=int, default=None, help='sample: top-k filter')
    g.add_argument('--top-p', type=float, default=None)
    g.add_argument('--temperature', type=float, default=None)
    g.add_argument('--typical-p', type=float, default=None, help='sample: typical-decoding mass')
    g.add_argument('--repetition-penalty', type=float, default=None,
                   help='sample: penalty on already-emitted tokens (1 = off)')
    g.add_argument('--kv-cache', default='bf16', choices=['bf16', 'int8'],
                   help='decode cache storage (TF-XL ring and Reformer LSH caches)')
    g.add_argument('--max-length', type=int, default=None)
    g.add_argument('--repair', default='full', choices=['none', 'grammar', 'full'],
                   help="post-sample token repair before rendering: 'full' also exact-fills "
                        'bar durations so every output re-extracts under the strict grammar')
    g.add_argument('--seed', type=int, default=None)
    g.add_argument('--key', help='prompt key for key-augmented models, e.g. CMajor')
    g.add_argument('--condition-on', help='extracted .mxl (or token string) to continue')
    g.add_argument('--n-bar', type=int, default=4, help='prompt bars when conditioning')
    g.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    g.set_defaults(fn=_cmd_generate)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        rc = args.fn(args)
        sys.stdout.flush()      # surface EPIPE here, not at shutdown flush
        return rc
    except NotImplementedError as e:
        print(f'error: {e}', file=sys.stderr)
        return 2
    except BrokenPipeError:                 # e.g. `... generate | head`
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0


if __name__ == '__main__':
    raise SystemExit(main())
