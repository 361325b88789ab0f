"""How far zamba2-7b's decode and forward part with depth, on the card.

At published widths, random weights from a seed, for each depth in
``--layers`` and each dtype in ``--dtypes``: 4 prompts of 16 tokens and
32 greedy ones through ``serve.engine.generate``, then

* decode against the teacher-forced forward of the same tokens (the
  largest and the mean |logit difference|, the arg-max agreement), and
* the forward of the batch against the forward of its first sequence
  alone (the same function; only the products' shapes, and so their
  summation order, differ),

each as a fraction of the forward logits' largest |value| and standard
deviation.  Where the second parts the paths as far as the first, the gap
is rounding amplified through the layers, not a fault of the decode path.
Prints the card's name and power limit, then one JSON line a case::

    python3 tools/recurrent_depth_sweep.py [--layers 7,14,28,56,81]
        [--dtypes float32,bfloat16]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="7,14,28,56,81")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("recurrent_depth_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.models import schema
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    batch, prompt_len, new = 4, 16, 32
    for layers in (int(x) for x in args.layers.split(",")):
        for dt in args.dtypes.split(","):
            cfg = dataclasses.replace(get_config("zamba2-7b"),
                                      num_layers=layers, dtype=dt)
            gen = torch.Generator(device=dev)
            gen.manual_seed(args.seed)
            params = schema.init_params(T.build_schema(cfg), gen,
                                        getattr(torch, dt), dev)
            rng = np.random.default_rng(args.seed)
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (batch, prompt_len)).astype(
                    np.int32)).to(dev)
            sess = engine.start_session(cfg, params, batch,
                                        prompt_len + new + 1, device=dev)
            toks, logits = engine.generate(sess, prompt, new,
                                           return_logits=True)
            seq = torch.cat([prompt, toks[:, :-1]], dim=1)
            with torch.no_grad():
                full = T.forward(params, cfg, {"tokens": seq})[0]
                alone = T.forward(params, cfg, {"tokens": seq[:1]})[0]
            scale, std = float(full.abs().max()), float(full.std())
            v = cfg.vocab_size

            def gap(a, b):
                d = (a - b).abs()
                return dict(max_rel=float(d.max()) / scale,
                            mean_rel_std=float(d.mean()) / std,
                            argmax_agreement=float(
                                (a[..., :v].argmax(-1)
                                 == b[..., :v].argmax(-1)).float().mean()))
            print(json.dumps(dict(
                config=cfg.name, layers=layers, dtype=dt,
                decode_vs_forward=gap(logits[:, :-1], full),
                batch_vs_alone=gap(full[:1], alone))), flush=True)
            del params, sess, logits, full, alone
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
