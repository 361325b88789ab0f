"""Throughput of ``mma.sync`` m16n8k8 TF32 on the card, the instruction the
port's ``flash_attention.cu`` runs on: by warps an SM and independent
accumulator chains a warp, then with non-mma instructions between the
mmas.  Compiles ``tools/mma_sync_bench.cu`` with ``nvcc`` (sm_90a) into the
port's ignored build directory and prints its JSON lines after the card's
name and power limit.

    python3 tools/mma_sync_bench.py
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_ROOT / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = out_dir / "mma_sync_bench"
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-o", str(exe),
                    os.path.join(ROOT, "tools", "mma_sync_bench.cu")],
                   check=True, timeout=_build.NVCC_TIMEOUT_S)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return subprocess.run([str(exe)], timeout=600).returncode


if __name__ == "__main__":
    sys.exit(main())
