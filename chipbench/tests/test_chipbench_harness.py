"""The harness: found by name, importing nothing it may not, and keeping
to the benchmark file's contract."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "chipbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    dynamic = re.findall(r"import_module\(\s*f?[\"']([\w.]+)",
                         path.read_text())
    return names | set(dynamic)


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    tops = {n.split(".")[0] for n in imported_modules(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if "reference" in path.relative_to(PKG).parts:
        assert "repro_torch" not in tops


def test_the_check_compares_whole_top_level_names():
    from chipbench import run
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_extra"] = sys.modules["json"]
        assert "repro" not in run.forbidden_modules()
        sys.modules["repro.core"] = sys.modules["json"]
        assert run.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


PACED_LOOP = '''"""Numeric reuse with a pause before each call."""
import time

from chipbench.loops import reuse

KEYS = {**reuse.KEYS, "pause_s": float}
PLANS = reuse.PLANS
inputs = reuse.inputs


class Loop(reuse.Loop):
    def prepare(self, i, rec):
        super().prepare(i, rec)
        time.sleep(self.cell.mix["pause_s"])
'''


def test_a_new_config_traffic_loop_and_metric_are_found_by_name(tmp_path):
    """Copy the benchmark, add one file of each kind (a configuration, a
    traffic mix with a loop of its own, a per-layer metric) and entries
    naming them, edit no file, and run the new cell on the host."""
    shutil.copytree(PKG, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((PKG / "configs" / "graph500_s16.json").read_text())
    cfg.update(name="graph500_s8", scale=8, edgefactor=8)
    (tmp_path / "chipbench/configs/graph500_s8.json").write_text(
        json.dumps(cfg))
    (tmp_path / "chipbench/loops/paced.py").write_text(PACED_LOOP)
    mix = json.loads((PKG / "traffic" / "reuse.json").read_text())
    mix.update(name="reuse_paced", loop="paced", pause_s=0.01)
    (tmp_path / "chipbench/traffic/reuse_paced.json").write_text(
        json.dumps(mix))
    (tmp_path / "chipbench/layer_metrics/calls_bounded.py").write_text(
        "def read(ctx):\n    return float(len(ctx.call_bounds))\n")
    bench["configs"].append(dict(name="graph500_s8", source="x",
                                 file="chipbench/configs/graph500_s8.json",
                                 reduced=["scale"], why="x"))
    bench["workloads"].append(dict(name="graph500_s8.reuse_paced",
                                   config="graph500_s8",
                                   traffic="reuse_paced", chips=1, why="x"))
    bench["per_layer"].append(dict(name="calls_bounded", unit="calls",
                                   better="higher", source="device_trace",
                                   layer="x", moves="gprod_per_s"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json; from chipbench import run, driver, work;"
        "from chipbench.layer_metrics import find;"
        "b = json.load(open('BENCHMARK.json'));"
        "cell, cfg, mix = run.load_cell(b, 'graph500_s8.reuse_paced');"
        "names = [m['name'] for m in run.cell_metrics(b, cell['name'], 1)];"
        "out = driver.run(cfg, mix, 5, 0.5, False, 'cpu', 0.0,"
        " peak=work.peaks('NVIDIA H100 80GB HBM3'));"
        "line = run.result_line(b, cell['name'], out, False, {});"
        "print(json.dumps([cfg['scale'], names, line['correct'],"
        " line['attempted'], find('calls_bounded').read(out['ctx'])]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    scale, names, correct, attempted, bounded = json.loads(
        out.stdout.splitlines()[-1])
    assert (scale, correct) == (8, True)
    assert names == ["calls_bounded"]
    # a 10 ms pause a call caps a 0.5 s window at 50 calls
    assert 0 < attempted <= 51 and bounded == attempted


@pytest.mark.parametrize("change", [
    dict(loop="open"), dict(callers=4), dict(warm_calls=2.0),
    dict(check_first=None)], ids=["unknown_loop", "unread_key", "type",
                                  "missing"])
def test_a_mix_the_benchmark_cannot_run_is_refused(change):
    from chipbench import loops
    mix = json.loads((PKG / "traffic" / "reuse.json").read_text())
    mix.update(change)
    mix = {k: v for k, v in mix.items() if v is not None}
    with pytest.raises((ValueError, ModuleNotFoundError)):
        loops.load(mix)


@pytest.mark.parametrize("change", [
    dict(product="A*B"), dict(dtype="float64"), dict(scale=None)],
    ids=["unread_key", "dtype", "missing"])
def test_a_config_the_benchmark_cannot_run_is_refused(change):
    from chipbench.cell import Cell
    cfg = json.loads((PKG / "configs" / "graph500_s16.json").read_text())
    mix = json.loads((PKG / "traffic" / "reuse.json").read_text())
    cfg.update(change)
    cfg = {k: v for k, v in cfg.items() if v is not None}
    with pytest.raises(ValueError):
        Cell(cfg, mix, 1, "cpu")


@pytest.mark.parametrize("path", sorted((PKG / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_mix_and_config_is_one_the_benchmark_runs(path):
    from chipbench import loops
    from chipbench.cell import Cell
    mix = json.loads(path.read_text())
    loops.load(mix)
    for c in BENCH["configs"]:
        Cell(json.loads((ROOT / c["file"]).read_text()), mix, 1, "cpu")


def test_without_a_card_the_run_prints_nothing_and_fails(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "chipbench.run", "--workload",
         "graph500_s16.reuse", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_with_only_the_benchmark_files_the_run_fails(tmp_path):
    shutil.copytree(PKG, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "-m", "chipbench.run", "--workload",
         "hypre_27pt_128.reuse", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "chipbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg.get("reduced", {}))
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and (PKG / "layer_metrics" /
                                      f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])
    every = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for e in every:
        assert NAME.match(e["name"])
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
