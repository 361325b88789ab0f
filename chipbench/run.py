"""Run one cell of the benchmark once and print its result line.

    python3 -m chipbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix and
metrics are found by name from ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json``, the loop that the mix names
(``loops/<loop>.py``), the configuration's generator
(``generators/<name>.py``) and one reader a per-layer metric
(``layer_metrics/<metric>.py``).  The last line of standard output is one
JSON object; the last lines of standard error are the numbers compared,
each beside its limit, after the host seconds of each set-up step.  Exits non-zero, printing no result, without a CUDA
device, when the program cannot be imported, or when JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """The workload entry, its configuration and its traffic mix."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json"
                      ).read_text())
    return cell, cfg, mix


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports in a run with or without the trace."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def result_line(bench, workload, out, trace, device_info) -> dict:
    from chipbench import check
    from chipbench import trace as tr
    from chipbench.layer_metrics import find
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = (find(m["name"]).read(out["ctx"]) if trace
                 else out["metrics"].get(m["name"]))
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    checks, ok = check.numbers(out["readings"], out["failed"])
    line = dict(correct=bool(ok), attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=device_info)
    t = out["ctx"].trace
    if trace and t is not None and t.window:
        lo, hi = t.window
        device_info.update(busy_s=tr.busy(t, lo, hi), window_s=hi - lo)
        line["breakdown"] = tr.breakdown(t)
    line["setup_steps"] = out["setup_steps"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, mix = load_cell(bench, args.workload)
    sys.path.insert(0, str(ROOT / "src"))
    # the bytecode of every module imported from here on, torch's among
    # them, is cached at a fixed path inside the checkout, also where the
    # environment asks the interpreter to write none (PYTHONDONTWRITEBYTECODE):
    # a torch installed without bytecode is then compiled in a checkout's
    # first run only, not in every run (some 9 s of set-up)
    sys.pycache_prefix = str(ROOT / ".pycache")
    sys.dont_write_bytecode = False
    steps = {}
    t = time.perf_counter()
    import torch
    steps["import_torch"] = time.perf_counter() - t
    t = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    steps["find_devices"] = time.perf_counter() - t
    t = time.perf_counter()
    try:
        import repro_torch.core.plan  # noqa: F401
    except ImportError as e:
        print(f"the program cannot be imported: {e}", file=sys.stderr)
        return 2
    from chipbench import driver, work
    steps["import_program"] = time.perf_counter() - t
    kind = torch.cuda.get_device_name(0)
    out = driver.run(cfg, mix, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START, peak=work.peaks(kind), steps=steps)
    device_info = dict(platform="gpu", kind=kind, count=int(cell["chips"]),
                       memory_peak_bytes=out["memory_peak"])
    line = result_line(bench, args.workload, out, bool(args.trace),
                       device_info)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    for note in out["notes"]:
        print(note, file=sys.stderr)
    print("setup_steps " + " ".join(f"{k} {v!r}" for k, v in
                                     out["setup_steps"].items()),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
