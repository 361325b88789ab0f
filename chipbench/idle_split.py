"""One traced run of a cell, its idle time split by the program's spans.

    python3 -m chipbench.idle_split --workload <name> --seed <n> --seconds <s>

from the root of a checkout, on a CUDA device.  Runs the cell as
``chipbench.run`` does with ``--trace 1`` and prints one JSON line: the
cell's per-layer metrics, the run's end-to-end values (measured with the
profiler on), the window's idle seconds by benchmark span and by the
program's innermost span (``call/execute.readback``, ``plan/plan.bin``;
:func:`chipbench.program_spans.idle_split`), the share of the idle time
inside the benchmark's ``call`` and ``plan`` spans that a program span
labels, the share of the device operations inside ``call`` spans that
started inside an ``execute`` span, and the host seconds the per-layer
readers took.  Where the program keeps no spans the split has the
benchmark's labels alone.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def labelled_share(split: dict, outer: tuple = ("call", "plan")):
    """Share of the idle seconds inside ``outer`` spans that carry a
    program span's label (None where there are none)."""
    inside = {k: v for k, v in split.items() if k.split("/")[0] in outer}
    total = sum(inside.values())
    return (sum(v for k, v in inside.items() if "/" in k) / total
            if total else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from chipbench import run
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    _, cfg, mix = run.load_cell(bench, args.workload)
    sys.path.insert(0, str(run.ROOT / "src"))
    sys.pycache_prefix = str(run.ROOT / ".pycache")
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chipbench import driver, work
    from chipbench import program_spans as ps
    from chipbench import trace as tr
    kind = torch.cuda.get_device_name(0)
    t = time.perf_counter()
    out = driver.run(cfg, mix, args.seed, args.seconds, True, "cuda",
                     T_START, peak=work.peaks(kind))
    run_s = time.perf_counter() - t
    t = time.perf_counter()
    line = run.result_line(bench, args.workload, out, True,
                           dict(kind=kind, memory_peak_bytes=out["memory_peak"]))
    readers_s = time.perf_counter() - t
    trace = out["ctx"].trace
    spans = ps.load() or []
    split = ps.idle_split(trace, spans)
    calls = tr.spans_named(trace, "call")
    in_calls = ps.ops_starting_in(trace, calls)
    in_exec = set(ps.ops_starting_in(
        trace, [(s, e) for _, s, e, _ in ps.top(spans, "execute")]))
    line.update(
        end_to_end=out["metrics"], window_s=out["window_s"],
        idle_split=split, labelled_share=labelled_share(split),
        ops_in_calls=len(in_calls),
        ops_in_execute_share=(sum(o in in_exec for o in in_calls)
                              / len(in_calls) if in_calls else None),
        program_spans=len(spans), counters=ps.counters(),
        run_s=run_s, readers_s=readers_s)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
