"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`.  All sources
compile at once, one ``nvcc`` process each.  Libraries land in
``kernels/_build/<hash>/``, keyed on a hash of the sources and the flags, so
an edited source rebuilds and an unchanged one is reused.  Nothing here runs
at import time: ``ctypes`` and ``nvcc`` are reached only when a kernel is
first launched on a CUDA tensor.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600

_LIBS: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use on a machine with the CUDA toolkit")


def build_all() -> dict:
    """Compile every source that has no library yet; returns
    ``{"seconds": wall time, "built": [names]}``."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [s for s in _sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        procs = []
        for src in todo:
            tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, proc in procs:
            try:
                log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out_dir / f"lib{src.stem}.so")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return dict(seconds=time.perf_counter() - t0,
                built=[s.stem for s in todo])


def load(name: str):
    """The loaded ``lib<name>.so`` (built first if needed), with the two
    entry points every source exports declared: ``<name>_error_string`` and
    ``<name>_max_smem``."""
    if name not in _LIBS:
        import ctypes
        path = _build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        smem = getattr(lib, f"{name}_max_smem")
        smem.argtypes = [ctypes.c_int]
        smem.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def launcher(name: str, signature: str, entry: str | None = None):
    """``<entry>_launch`` of ``lib<name>.so`` (``entry`` defaults to
    ``name``; a source may export a second entry point) with its C signature
    declared: one letter per argument, ``p`` a pointer (device pointers and
    the stream), ``i`` an int, ``q`` a long long.  Returns an int error
    code."""
    return function(name, f"{entry or name}_launch", signature)


def function(name: str, symbol: str, signature: str, restype: str = "i"):
    """``symbol`` of ``lib<name>.so`` with its C signature declared in the
    letters of :func:`launcher`, returning ``restype`` (one such letter)."""
    import ctypes
    types = dict(p=ctypes.c_void_p, i=ctypes.c_int, q=ctypes.c_longlong)
    fn = getattr(load(name), symbol)
    fn.argtypes = [types[c] for c in signature]
    fn.restype = types[restype]
    return fn


def check(name: str, rc: int) -> None:
    """Raise if a launcher returned a CUDA error (``cudaGetLastError`` after
    the launch, or a failed attribute call before it)."""
    if rc != 0:
        msg = getattr(load(name), f"{name}_error_string")(rc)
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg.decode()}")


# --------------------------------------------------------------------------- #
# Binding helpers shared by the kernel wrappers
# --------------------------------------------------------------------------- #
def kernel_device(name: str, *tensors) -> torch.device | None:
    """``None`` when every tensor lies on the CPU (the wrapper then runs its
    plain version), else the one CUDA device they all lie on.  Anything
    else — mixed devices, another device type — raises."""
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return None
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise RuntimeError(f"{name}: tensors must all lie on the CPU or all "
                           f"on one CUDA device, got {sorted(map(str, devs))}")
    return next(iter(devs))


def require(name: str, t, dtype, what: str) -> int:
    """Check a tensor handed to a kernel (dtype, 1-D, contiguous) and
    return its device pointer."""
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise RuntimeError(f"{name}: {what} must be a contiguous 1-D {dtype} "
                           f"tensor, got {t.dtype} shape {tuple(t.shape)}")
    return t.data_ptr()


# dtype codes of the kernels that take floating tensors of any width
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def require_float(name: str, t, dtype, what: str) -> tuple[int, int]:
    """Check a floating tensor handed to a kernel (``dtype``, one of
    :data:`FLOAT_CODES`, contiguous, any shape) and return its device
    pointer and dtype code."""
    if dtype not in FLOAT_CODES or t.dtype != dtype or not t.is_contiguous():
        raise RuntimeError(f"{name}: {what} must be a contiguous {dtype} "
                           f"tensor of float32, bfloat16 or float16, got "
                           f"{t.dtype} shape {tuple(t.shape)}")
    return t.data_ptr(), FLOAT_CODES[dtype]


def require_csr(name: str, m, what: str, values: bool = False) -> list:
    """Check a CSRDevice handed to a kernel (int32 ``rpt`` of ``nrows + 1``,
    int32 ``col`` and, with ``values``, float32 ``val`` of the capacity) and
    return the pointers ``[rpt, col(, val)]``."""
    if m.rpt.shape[0] != m.nrows + 1 or (values and m.val.shape != m.col.shape):
        raise RuntimeError(f"{name}: {what} is not a consistent CSRDevice")
    ptrs = [require(name, m.rpt, torch.int32, f"{what}.rpt"),
            require(name, m.col, torch.int32, f"{what}.col")]
    if values:
        ptrs.append(require(name, m.val, torch.float32, f"{what}.val"))
    return ptrs


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_SMEM: dict = {}


def max_smem(name: str, device) -> int:
    """Opt-in dynamic shared memory per block on ``device``, in bytes."""
    key = (name, device.index)
    if key not in _SMEM:
        v = getattr(load(name), f"{name}_max_smem")(device.index or 0)
        if v <= 0:
            raise RuntimeError(f"{name}: cannot read the shared-memory limit "
                               f"of {device}")
        _SMEM[key] = v
    return _SMEM[key]


# Global scratch the row kernels may take: for rows whose workspace does not
# fit shared memory (power-law hub buckets), and for the BIN kernel's
# scattered pairs.  One slice per resident block.
SCRATCH_BYTES = 1 << 30
STATIC_SMEM_RESERVE = 1024   # the kernels' own static shared memory


def align16(n: int) -> int:
    return -(-int(n) // 16) * 16


def row_threads(lanes: int) -> int:
    """Threads of a one-block-per-row kernel whose rows hold up to ``lanes``
    products (a power of two): two products a thread, 32 to 512."""
    return min(512, max(32, lanes // 2))


def block_workspace(name: str, device, ws_bytes: int, threads: int,
                    n_rows: int, pair_bytes: int = 0):
    """Launch shape of a one-block-per-row kernel: ``(grid, threads,
    smem_bytes, scratch, slice_bytes, ws_off)``.

    Each resident block gets a ``slice_bytes`` slice of the global
    ``scratch`` tensor (``None`` when no block needs one), holding first
    ``pair_bytes`` of the kernel's own global buffers, then the row's
    ``ws_bytes`` workspace when that does not fit the card's opt-in shared
    memory: ``ws_off`` is then its offset in the slice, else -1 and the
    workspace is ``smem_bytes`` of dynamic shared memory.  Blocks loop over
    the rows when the grid is cut to keep scratch within
    :data:`SCRATCH_BYTES`; a workspace in scratch runs 1024 threads."""
    in_smem = ws_bytes + STATIC_SMEM_RESERVE <= max_smem(name, device)
    slice_bytes = align16(pair_bytes) + (0 if in_smem else align16(ws_bytes))
    if slice_bytes == 0:
        return n_rows, threads, ws_bytes, None, 0, -1
    grid = max(1, min(n_rows, SCRATCH_BYTES // slice_bytes))
    scratch = torch.empty(grid * slice_bytes, dtype=torch.uint8,
                          device=device)
    if in_smem:
        return grid, threads, ws_bytes, scratch, slice_bytes, -1
    return grid, 1024, 0, scratch, slice_bytes, align16(pair_bytes)


def sort_workspace(name: str, device, max_deg_a: int, lanes: int,
                   n_rows: int):
    """Launch shape of a one-block-per-row sort whose rows each hold at most
    ``lanes`` keys of 4 bytes (a power of two): ``(smem_lanes, grid,
    threads, smem_bytes, scratch, slice_bytes)``.

    Unlike :func:`row_workspace`, which places every row's workspace in
    shared memory or every row's in scratch, the choice is made per row:
    shared memory holds the row's product prefix and ``smem_lanes`` keys —
    ``lanes``, or the largest power of two that fits the opt-in limit — and
    a row whose padded product count exceeds ``smem_lanes`` sorts in the
    block's ``slice_bytes`` slice of ``scratch`` (``None`` when no row
    needs it).  ``smem_lanes`` is -1 when not even the prefix fits; the
    prefix then heads the slice and every row sorts in scratch."""
    pre = align16(4 * (max_deg_a + 1))
    room = max_smem(name, device) - STATIC_SMEM_RESERVE - pre
    if 4 * lanes <= room:
        return lanes, n_rows, row_threads(lanes), pre + 4 * lanes, None, 0
    if room >= 4 * 32:
        smem_lanes = 1 << ((room // 4).bit_length() - 1)
        smem_bytes, slice_bytes = pre + 4 * smem_lanes, 4 * lanes
    else:
        smem_lanes, smem_bytes, slice_bytes = -1, 0, pre + 4 * lanes
    grid = max(1, min(n_rows, SCRATCH_BYTES // slice_bytes))
    scratch = torch.empty(grid * slice_bytes, dtype=torch.uint8,
                          device=device)
    return smem_lanes, grid, 1024, smem_bytes, scratch, slice_bytes


def row_workspace(name: str, device, max_deg_a: int, f2: int,
                  lane_bytes: int, n_rows: int):
    """Launch shape of a one-block-per-row ESC kernel: ``(ws_bytes, grid,
    threads, smem_bytes, scratch)``.  A row's workspace (``csrc/common.cuh``)
    is A's row prefix (``max_deg_a + 1`` ints, 16-byte aligned) and ``f2``
    lanes of ``lane_bytes`` each, in shared memory when it fits (``scratch``
    is then ``None``), else in a global scratch tensor of ``grid`` slices
    (:func:`block_workspace`)."""
    ws_bytes = align16(4 * (max_deg_a + 1)) + lane_bytes * f2
    grid, threads, smem, scratch, _, _ = block_workspace(
        name, device, ws_bytes, row_threads(f2), n_rows)
    return ws_bytes, grid, threads, smem, scratch
