"""The port's dry run (``launch/dryrun.py``) on fake process groups, in a
subprocess of their own, so that no fake group meets another test's.

* The mini dry run, as the JAX package's ``test_dryrun_mini.py``:
  deepseek-v3's smoke config (MLA and MoE, FSDP rules) trained one step on
  a fake (2, 4) ``cpu`` mesh must count FLOPs and collective bytes (a
  sharded step communicates) and a peak.  JAX's own test fails on JAX 0.9
  (ROADMAP R5); this one holds the port to the same assertions.
* ``python -m repro_torch.launch.dryrun``'s main path on the production
  (16, 16) mesh of 256 fake ranks, with the smoke configs in place of the
  full ones (the trace's cost is per op, and the full widths take ~40 s a
  cell): a train (M-RoPE positions), an MLA decode and a long-context
  (batch 1, zamba2's states and windowed cache) cell write their records,
  which the report reads back.
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

SCRIPT = r"""
import json
import sys
from repro_torch.configs import base
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh, mesh_chip_count
from repro_torch.roofline import report

with dryrun.fake_world(8):
    square = make_test_mesh(8, device="cpu")          # JAX's (4, 2)
    assert tuple(square.shape) == (4, 2) and mesh_chip_count(square) == 8
print(json.dumps(dryrun.mini_dry_run("cpu")))

dryrun.get_config = base.get_smoke_config
out = sys.argv[1]
for arch, shape in (("qwen2-vl-72b", "train_4k"),
                    ("deepseek-v3-671b", "decode_32k"),
                    ("zamba2-7b", "long_500k")):
    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                 "--device", "cpu", "--out", out])
print(report.dryrun_summary(out))
print(report.roofline_table(out))
"""


@pytest.fixture(scope="module")
def dryrun_run(tmp_path_factory):
    """The mini dry run, then the three cells, in one subprocess: (its
    output lines, the records' directory)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", SCRIPT, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout.strip().splitlines(), out


def test_mini_dryrun_2x4_fake_mesh(dryrun_run):
    lines, _ = dryrun_run
    rec = json.loads(next(line for line in lines if line.startswith("{")))
    assert rec["flops"] > 0
    assert rec["collective_bytes"] > 0   # sharded training must communicate
    assert rec["peak_bytes"] > 0


def test_dryrun_cells_on_the_production_mesh(dryrun_run):
    lines, tmp_path = dryrun_run
    out = "\n".join(lines)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".json"))
    assert files == ["deepseek-v3-671b__decode_32k__single.json",
                     "qwen2-vl-72b__train_4k__single.json",
                     "zamba2-7b__long_500k__single.json"]
    for name in files:
        with open(tmp_path / name) as f:
            rec = json.load(f)
        assert rec["chips"] == 256 and rec["mesh"] == "single"
        assert rec["device"] == "cpu" and rec["trace_s"] > 0
        counts = rec["hlo_parsed"]
        assert counts["flops"] > 0 and counts["bytes"] > 0
        mem = rec["memory_analysis"]
        assert mem["peak_size"] == mem["argument_size"] + mem["temp_size"]
        assert mem["argument_size"] > 0
        rl = rec["roofline"]
        assert rl["flops_per_chip"] == counts["flops"]
        assert rl["bottleneck"] in ("compute", "memory", "collective")
    with open(tmp_path / files[1]) as f:
        train = json.load(f)
    # the ZeRO state and the tensor-parallel blocks communicate
    assert train["hlo_parsed"]["collectives"]["all-gather"] > 0
    assert train["hlo_parsed"]["collectives"]["all-reduce"] > 0
    assert "3 single-pod + 0 multi-pod cells traced" in out
    assert "| qwen2-vl-72b | train_4k |" in out
