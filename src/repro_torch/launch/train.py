"""Training entry point: config → data → train loop → checkpoints.

Runs on one device: the CUDA card unless ``--device cpu`` is passed.  Fault
tolerance in the loop: resume-from-latest on start, periodic atomic
checkpoints, preemption-safe (SIGTERM triggers a checkpoint before exit).
Checkpoints are in the JAX package's format (``ckpt/checkpoint.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --steps 50 --smoke --batch 8 --seq 128 --ckpt-dir /tmp/run1 \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.csr import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import transformer as tmod
from repro_torch.models.schema import init_params
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_loop import make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the host)")
    return ap.parse_args(argv)


def make_batch(cfg, data: SyntheticLM, i: int, batch: int, dev) -> dict:
    """Step ``i``'s batch on ``dev``, with the frontends' stub inputs."""
    b = data.batch(i)
    out = {k: torch.from_numpy(b[k]).to(dev)
           for k in ("tokens", "labels", "positions")}
    if cfg.mrope_sections:
        out["positions"] = out["positions"][None].expand(
            (3,) + tuple(b["positions"].shape))
    dtype = getattr(torch, cfg.dtype)
    if cfg.frontend == "vision_stub":
        rng = np.random.default_rng(i)
        out["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, 8, cfg.d_model)).astype(np.float32)).to(dev, dtype)
    if cfg.frontend == "audio_stub":
        rng = np.random.default_rng(i)
        out["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32)).to(dev, dtype)
    return out


def main(argv=None, on_step=None):
    """Train; returns (first loss, mean of the last five).

    ``on_step(step, metrics, params, opt_state)``, where given, is called
    after each step (``step`` counts from 1; ``metrics`` holds the step's
    0-d tensors)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    schema = tmod.build_schema(cfg, mesh_model=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(schema, gen, getattr(torch, cfg.dtype), dev)
    opt_cfg = opt_mod.AdamWConfig(lr_peak=args.lr, warmup_steps=args.warmup,
                                  total_steps=args.steps,
                                  state_dtype=cfg.opt_state_dtype)
    opt_state = opt_mod.init_state(opt_cfg, params)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))

    start_step = 0
    if args.ckpt_dir and ckpt_mod.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), _extra, start_step = ckpt_mod.restore(
            args.ckpt_dir, (params, opt_state))
        print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = make_train_step(cfg, opt_cfg, accum=args.accum)

    stop = {"now": False}
    previous = None
    if args.ckpt_dir:
        def _sig(_s, _f):
            stop["now"] = True
        previous = signal.signal(signal.SIGTERM, _sig)

    try:
        losses = []
        t0 = time.time()
        for i in range(start_step, args.steps):
            params, opt_state, metrics = step_fn(
                params, opt_state, make_batch(cfg, data, i, args.batch, dev))
            losses.append(float(metrics["loss"]))
            if on_step is not None:
                on_step(i + 1, metrics, params, opt_state)
            if (i + 1) % args.log_every == 0 or i == args.steps - 1:
                print(f"[train] step {i+1:5d} loss {losses[-1]:.4f} "
                      f"ce {float(metrics['ce']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({(time.time()-t0)/max(i+1-start_step,1):.2f}s/step)",
                      flush=True)
            if args.ckpt_dir and ((i + 1) % args.ckpt_every == 0
                                  or stop["now"] or i == args.steps - 1):
                ckpt_mod.save(args.ckpt_dir, i + 1, (params, opt_state),
                              extra={"seed": args.seed})
                if stop["now"]:
                    print("[train] preemption checkpoint written; exiting",
                          flush=True)
                    sys.exit(0)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    first, last = losses[0], np.mean(losses[-5:])
    print(f"[train] done: first loss {first:.4f} → last(avg5) {last:.4f}")
    return first, last


if __name__ == "__main__":
    main()
