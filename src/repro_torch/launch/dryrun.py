"""Dry run: trace every (arch × shape × mesh) cell of the LM stack.

For each live cell this script runs the real step function (``train_step``
/ ``forward`` / ``decode_step``) once, with its parameters, optimizer
state (ZeRO specs), batch and decode cache laid out by the production
specs as DTensors on the single-pod (16, 16) or multi-pod (2, 16, 16)
mesh, and records a chip's FLOPs, bytes, collective bytes and peak bytes
(``roofline.hlo_cost``) and the roofline to ``<out>/<arch>__<shape>__
<mesh>.json``.

Nothing is allocated and no card is needed: the mesh's 256 or 512 ranks
are a fake process group (this process is rank 0; its collectives move
nothing) and every tensor is a fake tensor (shape, dtype and device, no
storage).  The fake process group is PyTorch's internal test module
``torch.testing._internal.distributed.fake_pg``, imported only here.
``--device`` names the device type the fake tensors claim: ``cuda`` by
default, ``cpu`` where PyTorch has no CUDA.  The counts are of rank 0;
every rank runs the same program on shards of the same size.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun           # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mini --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-125m \\
      --shape train_4k --mesh single --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import get_config, registry
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh, mesh_chip_count
from repro_torch.models import sharding
from repro_torch.models import transformer as tmod
from repro_torch.models.schema import PSpec
from repro_torch.roofline import analysis as roof
from repro_torch.roofline.hlo_cost import CostCounter
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_loop import make_train_step

DEFAULT_OUT = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "dryrun_out"))


@contextlib.contextmanager
def fake_world(ranks: int):
    """A default process group of ``ranks`` ranks whose collectives do
    nothing, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(shape, dtype, spec, mesh, device):
    """A DTensor of global ``shape`` laid out by ``spec``, this rank's
    shard a fake tensor (call under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    pl = sharding.placements(spec, mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] = -(-local[p.dim] // mesh.size(i))
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=device), mesh, pl,
        run_check=False, shape=torch.Size(shape), stride=tuple(stride))


def _fake_tree(tree, specs, mesh, device, dtype=None):
    """``tree`` (schema ``PSpec`` or ``meta`` tensor leaves, in dicts and
    named tuples) as fake DTensors laid out by ``specs``."""
    if isinstance(tree, dict):
        return {k: _fake_tree(tree[k], specs[k], mesh, device, dtype)
                for k in tree}
    if isinstance(tree, tuple) and not isinstance(tree, PSpec):
        return type(tree)(*(_fake_tree(t, s, mesh, device, dtype)
                            for t, s in zip(tree, specs)))
    return _fake(tuple(tree.shape), dtype or tree.dtype, specs, mesh, device)


def lower_cell(arch: str, shape: str, multi_pod: bool, *,
               device: str = "cuda") -> dict:
    """Trace one cell on a fake mesh (the caller's ``fake_world`` of 256
    or 512 ranks) and return its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    # the de-TP recipe only pays when the batch shards over BOTH mesh axes;
    # small-batch cells of sub-1B archs fall back to TP
    if not cfg.tensor_parallel:
        full = 512 if multi_pod else 256
        if specs_mod.SHAPES[shape]["batch"] % full != 0:
            cfg = dataclasses.replace(cfg, tensor_parallel=True)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    chips = mesh_chip_count(mesh)
    mesh_model = 16
    sh = specs_mod.SHAPES[shape]
    kind = sh["kind"]
    dt = getattr(torch, cfg.dtype)

    schema = tmod.build_schema(cfg, mesh_model=mesh_model)
    rules = sharding.make_rules(cfg, mesh_model=mesh_model,
                                multi_pod=multi_pod)
    pspecs = sharding.specs_from_schema(schema, rules)
    counter = CostCounter()
    with FakeTensorMode():
        params = _fake_tree(schema, pspecs, mesh, device, dt)
        if kind == "train":
            opt_cfg = opt_mod.AdamWConfig(state_dtype=cfg.opt_state_dtype)
            sd = getattr(torch, cfg.opt_state_dtype)
            # ZeRO: optimizer state additionally shards `embed` over
            # data(+pod)
            zero = opt_mod.zero_state_specs(schema, rules,
                                            multi_pod=multi_pod)
            state = opt_mod.AdamState(
                torch.zeros((), dtype=torch.int32, device=device),
                _fake_tree(schema, zero.mu, mesh, device, sd),
                _fake_tree(schema, zero.nu, mesh, device, sd))
            batch = _fake_tree(specs_mod.batch_structs(cfg, shape),
                               specs_mod.batch_pspecs(cfg, shape, multi_pod),
                               mesh, device)
            step = make_train_step(cfg, opt_cfg)
            args = (params, state, batch)

            def run():
                # the update keeps each parameter's and moment's layout
                # (JAX's ``out_shardings``)
                step(params, state, batch)
            mflops = roof.model_flops_train(cfg, sh["batch"] * sh["seq"])
        elif kind == "prefill":
            batch = _fake_tree(specs_mod.batch_structs(cfg, shape),
                               specs_mod.batch_pspecs(cfg, shape, multi_pod),
                               mesh, device)
            args = (params, batch)

            def run():
                with torch.no_grad():
                    tmod.forward(params, cfg, batch)
            mflops = roof.model_flops_prefill(cfg, sh["batch"] * sh["seq"])
        else:  # decode
            tok_s, _, cache_s, enc_s = specs_mod.decode_structs(cfg, shape)
            tok_p, _, cache_p, enc_p = specs_mod.decode_pspecs(
                cfg, shape, multi_pod)
            tokens = _fake_tree(tok_s, tok_p, mesh, device)
            cache = _fake_tree(cache_s, cache_p, mesh, device)
            enc = (None if enc_s is None
                   else _fake_tree(enc_s, enc_p, mesh, device))
            cur_len = torch.zeros((), dtype=torch.int32, device=device)
            args = (params, tokens, cache, enc)

            def run():
                with torch.no_grad():
                    tmod.decode_step(params, cfg, tokens, cache, cur_len,
                                     enc_out=enc)
            mflops = roof.model_flops_decode(cfg, sh["batch"])
        counter.track(args)
        resident = counter.live_bytes
        t0 = time.perf_counter()
        with sharding.use_mesh(mesh), counter:
            run()
        trace_s = time.perf_counter() - t0
    parsed = counter.result()
    rl = roof.Roofline.build(parsed["flops"], parsed["bytes"],
                             parsed["collectives"], mflops, chips)
    tag = "multi" if multi_pod else "single"
    rec = dict(arch=arch, shape=shape, mesh=tag, chips=chips, kind=kind,
               device=device, trace_s=trace_s,
               memory_analysis=dict(argument_size=resident,
                                    temp_size=counter.peak_bytes - resident,
                                    peak_size=counter.peak_bytes),
               hlo_parsed=dict(flops=parsed["flops"], bytes=parsed["bytes"],
                               collectives=parsed["collectives"]),
               roofline=rl.to_dict())
    print(f"[dryrun] {arch} × {shape} × {tag}: trace {trace_s:.1f}s  "
          f"flops/chip {parsed['flops']:.3e}  bytes/chip "
          f"{parsed['bytes']:.3e}  coll/chip {parsed['collective_bytes']:.3e}B"
          f"  peak {counter.peak_bytes / 1e9:.2f} GB  bottleneck "
          f"{rl.bottleneck}", flush=True)
    return rec


def mini_dry_run(device: str = "cuda") -> dict:
    """The JAX package's mini dry run: deepseek-v3's smoke config (MLA and
    MoE) under FSDP rules, one train step on a fake (2, 4) mesh of
    ``device``; a chip's counts and peak bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import get_smoke_config
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(8):
        mesh = init_device_mesh(device, (2, 4),
                                mesh_dim_names=("data", "model"))
        cfg = get_smoke_config("deepseek-v3-671b")
        schema = tmod.build_schema(cfg, mesh_model=4)
        rules = sharding.make_rules(cfg, mesh_model=4, multi_pod=False,
                                    fsdp=True)
        pspecs = sharding.specs_from_schema(schema, rules)
        counter = CostCounter()
        with FakeTensorMode():
            params = _fake_tree(schema, pspecs, mesh, device, torch.float32)
            oc = opt_mod.AdamWConfig()
            state = opt_mod.init_state(oc, params)
            rows = sharding.P("data", None)
            batch = _fake_tree(
                {k: torch.empty((4, 32), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")},
                {"tokens": rows, "labels": rows}, mesh, device)
            step = make_train_step(cfg, oc)
            counter.track(params, state, batch)
            t0 = time.perf_counter()
            with sharding.use_mesh(mesh), counter:
                step(params, state, batch)
            trace_s = time.perf_counter() - t0
    return dict(counter.result(), peak_bytes=counter.peak_bytes,
                trace_s=trace_s, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--mini", action="store_true",
                    help="only the mini dry run (a fake 2 x 4 mesh); print "
                         "its counts as one JSON line")
    args = ap.parse_args(argv)
    if args.mini:
        print(json.dumps(mini_dry_run(args.device)), flush=True)
        return

    archs = [args.arch] if args.arch else list(registry().keys())
    shapes = [args.shape] if args.shape else list(specs_mod.SHAPES.keys())
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for mp in meshes:
        with fake_world(512 if mp else 256):
            for arch in archs:
                for shape in shapes:
                    if not specs_mod.cell_is_live(arch, shape):
                        print(f"[dryrun] skip {arch} × {shape} (DESIGN §6)",
                              flush=True)
                        continue
                    tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                    out = os.path.join(args.out, tag + ".json")
                    if os.path.exists(out):
                        print(f"[dryrun] cached {tag}", flush=True)
                        continue
                    try:
                        rec = lower_cell(arch, shape, mp, device=args.device)
                        with open(out + ".tmp", "w") as f:
                            json.dump(rec, f, indent=1)
                        os.replace(out + ".tmp", out)
                    except Exception as e:
                        traceback.print_exc()
                        failures.append((tag, f"{type(e).__name__}: {e}"))
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for t, e in failures:
            print("  ", t, e[:300])
        raise SystemExit(1)
    print("[dryrun] ALL CELLS TRACED", flush=True)


if __name__ == "__main__":
    main()
