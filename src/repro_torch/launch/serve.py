"""Serving entry point: load a training checkpoint (or init), serve batched
requests through ``serve.engine``.

Runs on the CUDA card unless ``--device cpu`` is passed.  A checkpoint of
``(params, opt_state)``, as ``launch.train`` writes it, is restored (the
optimizer state on the host, then dropped); one of params alone is the
fallback.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b \\
      --smoke --batch 4 --prompt-len 8 --gen 16 [--ckpt-dir /tmp/run1] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.csr import resolve_device
from repro_torch.models import transformer as tmod
from repro_torch.models.schema import init_params, tree_map
from repro_torch.serve import engine
from repro_torch.train import optimizer as opt_mod


def _opt_like(params) -> opt_mod.AdamState:
    """The default optimizer state's shapes on the ``meta`` device."""
    meta = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return opt_mod.AdamState(
        torch.empty((), dtype=torch.int32, device="meta"),
        tree_map(meta, params), tree_map(meta, params))


def main(argv=None):
    """Serve; returns the generated tokens (batch, gen) as numpy."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the host)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(tmod.build_schema(cfg, 1), gen,
                         getattr(torch, cfg.dtype), dev)
    if args.ckpt_dir and ckpt_mod.latest_step(args.ckpt_dir) is not None:
        # checkpoints store (params, opt_state); restore params only
        try:
            (params, _), _, step = ckpt_mod.restore(
                args.ckpt_dir, (params, _opt_like(params)))
            print(f"[serve] restored step {step}")
        except ckpt_mod.CheckpointMismatchError:
            params, _, step = ckpt_mod.restore(args.ckpt_dir, params)
            print(f"[serve] restored (params-only) step {step}")

    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    fe = None
    if cfg.is_encoder_decoder:
        fe = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32))
    sess = engine.start_session(cfg, params, args.batch,
                                args.prompt_len + args.gen + 1,
                                frame_embeds=fe, device=dev)
    t0 = time.time()
    toks = engine.generate(sess, prompts, args.gen,
                           temperature=args.temperature, seed=args.seed)
    toks = toks.cpu().numpy()
    dt = time.time() - t0
    print("[serve] generated:\n", toks)
    print(f"[serve] {args.batch * args.gen} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s batched)")
    return toks


if __name__ == "__main__":
    main()
