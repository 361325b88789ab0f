"""Markdown tables over the dry run's records (``launch.dryrun``)."""
from __future__ import annotations

import glob
import json
import os


def roofline_table(dryrun_dir: str, mesh: str = "single") -> str:
    rows = []
    for p in sorted(glob.glob(os.path.join(dryrun_dir, f"*__{mesh}.json"))):
        with open(p) as f:
            r = json.load(f)
        rl = r["roofline"]
        dom = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        frac = rl["compute_s"] / dom if dom else 0.0
        rows.append((r["arch"], r["shape"], rl, frac,
                     r["memory_analysis"].get("temp_size", 0)))
    out = ["| arch | shape | compute_s | memory_s | collective_s | bottleneck "
           "| useful FLOPs (6ND/HLO) | roofline frac | temp GB/chip |",
           "|---|---|---|---|---|---|---|---|---|"]
    for arch, shape, rl, frac, temp in rows:
        out.append(
            f"| {arch} | {shape} | {rl['compute_s']:.3f} | {rl['memory_s']:.3f}"
            f" | {rl['collective_s']:.3f} | {rl['bottleneck']} |"
            f" {rl['useful_flops_ratio']:.2f} | {frac:.3f} |"
            f" {temp/2**30:.1f} |")
    return "\n".join(out)


def dryrun_summary(dryrun_dir: str) -> str:
    """Cells by mesh and the median seconds a cell took to build: the JAX
    package's records compile (``compile_s``), the port's are traced
    (``trace_s``)."""
    n = {"single": 0, "multi": 0}
    secs, traced = [], False
    for p in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        n[r["mesh"]] += 1
        traced |= "trace_s" in r
        secs.append(r.get("trace_s", r.get("compile_s", 0)))
    verb, what = ("traced", "trace") if traced else ("compiled", "compile")
    return (f"{n['single']} single-pod + {n['multi']} multi-pod cells "
            f"{verb}; median {what} {sorted(secs)[len(secs)//2]:.0f}s")


if __name__ == "__main__":
    from repro_torch.launch.dryrun import DEFAULT_OUT
    print(dryrun_summary(DEFAULT_OUT))
    print(roofline_table(DEFAULT_OUT, "single"))
