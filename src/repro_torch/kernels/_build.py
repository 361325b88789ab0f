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

import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600

_LIBS: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_define(name: str, macro: str) -> int:
    """The integer that ``csrc/<name>.cu`` ``#define``s as ``macro``: a
    launch constant that the host side also needs (it sizes shared memory
    or splits rows between a kernel's parts), read from the source so that
    it is defined in one place; no build is needed."""
    import re
    text = (CSRC / f"{name}.cu").read_text()
    found = re.search(rf"^#define {macro} (\d+)\b", text, re.M)
    if found is None:
        raise RuntimeError(f"{name}.cu defines no integer {macro}")
    return int(found.group(1))


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


_FUNCS: dict = {}


def function(name: str, symbol: str, signature: str, restype: str = "i"):
    """``symbol`` of ``lib<name>.so`` with its C signature declared in the
    letters of :func:`launcher`, returning ``restype`` (one such letter);
    declared once, then served from a cache."""
    key = (name, symbol, signature, restype)
    if key not in _FUNCS:
        import ctypes
        types = dict(p=ctypes.c_void_p, i=ctypes.c_int, q=ctypes.c_longlong)
        fn = getattr(load(name), symbol)
        fn.argtypes = [types[c] for c in signature]
        fn.restype = types[restype]
        _FUNCS[key] = fn
    return _FUNCS[key]


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
    if all(t.is_cpu for t in tensors):
        return None
    if not all(t.is_cuda for t in tensors) or len(
            {t.get_device() for t in tensors}) != 1:
        raise RuntimeError(f"{name}: tensors must all lie on the CPU or all "
                           f"on one CUDA device, got "
                           f"{sorted({str(t.device) for t in tensors})}")
    return tensors[0].device


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
    """The raw handle of ``device``'s current stream, where kernels launch.
    torch's raw getter skips building a Stream object, which is most of
    this call's host time."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index or 0)
    return torch.cuda.current_stream(device).cuda_stream


_SMEM: dict = {}
_SMS: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device``."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device.index or 0).multi_processor_count
    return _SMS[device.index]


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


# Global scratch the row kernels may take, for rows whose workspace does not
# fit shared memory (power-law hub rows): one slice per resident block.
SCRATCH_BYTES = 1 << 30
STATIC_SMEM_RESERVE = 1024   # the kernels' own static shared memory


def align16(n: int) -> int:
    return -(-int(n) // 16) * 16


def row_threads(lanes: int) -> int:
    """Threads of a one-block-per-row kernel whose rows hold up to ``lanes``
    products (a power of two): two products a thread, 32 to 512."""
    return min(512, max(32, lanes // 2))


def scratch_slices(device, slice_bytes: int, n_rows: int):
    """``(grid, scratch)``: one ``slice_bytes`` slice of a global scratch
    tensor for each of ``grid`` blocks, the grid cut so that scratch stays
    within :data:`SCRATCH_BYTES` (blocks then loop over the rows)."""
    grid = max(1, min(n_rows, SCRATCH_BYTES // slice_bytes))
    return grid, torch.empty(grid * slice_bytes, dtype=torch.uint8,
                             device=device)


def block_workspace(name: str, device, ws_bytes: int, threads: int,
                    n_rows: int):
    """Launch shape of a one-block-per-row kernel whose every row takes the
    same ``ws_bytes`` workspace: ``(grid, threads, smem_bytes, scratch,
    slice_bytes)``.

    The workspace is ``smem_bytes`` of dynamic shared memory when it fits
    the card's opt-in limit (``scratch`` is then ``None``), else each
    resident block's ``slice_bytes`` slice of the global ``scratch`` tensor,
    with 1024 threads; blocks loop over the rows when the grid is cut to
    keep scratch within :data:`SCRATCH_BYTES`."""
    if ws_bytes + STATIC_SMEM_RESERVE <= max_smem(name, device):
        return n_rows, threads, ws_bytes, None, 0
    slice_bytes = align16(ws_bytes)
    grid, scratch = scratch_slices(device, slice_bytes, n_rows)
    return grid, 1024, 0, scratch, slice_bytes


def split_workspace(smem_limit: int, fixed_bytes: int, item_bytes: int,
                    items: int) -> tuple[int, int, int]:
    """Where a row's workspace goes when rows differ in size: a fixed part
    of ``fixed_bytes`` (the row's product prefix and tables) and up to
    ``items`` items of ``item_bytes`` each (the largest row's sort keys or
    pairs), on a card with ``smem_limit`` bytes of opt-in shared memory a
    block.  Returns ``(smem_items, smem_bytes, slice_bytes)``.

    Shared memory (``smem_bytes``) holds the fixed part and ``smem_items``
    items: all ``items`` when they fit, else as many as fit.  A row with
    more items than ``smem_items`` works in a global scratch slice of
    ``slice_bytes`` holding its items (0: every row fits).  When not even
    the fixed part and 32 items fit, ``smem_items`` is -1, shared memory
    holds nothing and the fixed part heads the slice.  So a row goes to
    scratch when its own items do not fit beside the fixed part, whatever
    the others hold."""
    room = smem_limit - STATIC_SMEM_RESERVE - fixed_bytes
    if item_bytes * items <= room:
        return items, fixed_bytes + item_bytes * items, 0
    if room >= item_bytes * 32:
        fit = room // item_bytes
        return fit, fixed_bytes + item_bytes * fit, item_bytes * items
    return -1, 0, fixed_bytes + item_bytes * items


# csrc/spa_numeric.cu: warps of a block, the fewest lanes a row takes, and
# the warps an SM must get from row groups before rows take whole blocks
SPA_WARPS = source_define("spa_numeric", "SPA_WARPS")
SPA_MIN_GROUP = source_define("spa_numeric", "SPA_MIN_GROUP")
SPA_FILL = source_define("spa_numeric", "SPA_FILL")


class SpaShape(NamedTuple):
    """Launch shape of the SPA numeric kernel (:func:`spa_numeric_shape`)."""

    group: int          # lanes a row takes (SPA_MIN_GROUP to 32; 0: a block)
    threads: int        # threads of a block
    unit_bytes: int     # a row unit's workspace
    smem_bytes: int     # dynamic shared memory of a block (0: none)
    slice_bytes: int    # each unit's scratch slice (0: shared memory)

    @property
    def units(self) -> int:
        """Rows a block holds at once."""
        return self.threads // self.group if self.group else 1


@functools.lru_cache(maxsize=256)
def spa_numeric_shape(smem_limit: int, max_deg_a: int, max_deg_b: int,
                      tile_n: int, n_rows: int, sms: int) -> SpaShape:
    """Kernel 5's launch shape for ``n_rows`` rows of at most ``max_deg_a``
    A entries over B rows of at most ``max_deg_b``, in tiles of ``tile_n``
    lanes, on a card of ``sms`` SMs with ``smem_limit`` bytes of opt-in
    shared memory a block.

    A row's unit holds four tables of ``max_deg_a + 1`` entries (B cursor,
    B row end, B tile stop, A value) and the tile's ``tile_n`` lanes.  A row
    takes a group of lanes, as many as a B row's entries (a power of two,
    :data:`SPA_MIN_GROUP` to 32), so 32 / group rows share a warp, and a
    block holds up to :data:`SPA_WARPS` warps' units in shared memory,
    fewer when fewer fit; when not even one warp's fit, the group widens to
    32 lanes, and if one unit still does not fit, every unit works in its
    own global scratch slice.  A launch whose groups would fill fewer than
    :data:`SPA_FILL` warps an SM gives each row a block of
    :data:`SPA_WARPS` warps instead (``group`` 0), whose unit also holds a
    fifth table (the entries' offsets), a copy of the tile's B entries
    (``max_deg_a * max_deg_b`` columns and values) and two tables a warp
    (where each entry's copy enters and leaves the warp's tile lanes), in
    shared memory or, past it, in the block's slice."""
    da, db = max(0, int(max_deg_a)), max(0, int(max_deg_b))
    table = align16(4 * (da + 1))
    unit = 4 * table + 4 * int(tile_n)
    room = smem_limit - STATIC_SMEM_RESERVE
    group = min(32, max(SPA_MIN_GROUP, _ceil_pow2(db)))
    if -(-int(n_rows) * group // 32) < sms * SPA_FILL:
        unit = (align16(5 * table + 4 * int(tile_n) + 8 * da * db)
                + 2 * SPA_WARPS * table)
        fits = unit <= room
        return SpaShape(0, 32 * SPA_WARPS, unit, unit if fits else 0,
                        0 if fits else unit)
    for g in (group, 32):
        warps = min(SPA_WARPS, room // (32 // g * unit))
        if warps >= 1:
            return SpaShape(g, 32 * warps, unit, warps * (32 // g) * unit, 0)
    return SpaShape(group, 32 * SPA_WARPS, unit, 0, unit)


# csrc/esc_symbolic.cu: a warp sorts a short row of up to SYM_WARP_MAX
# products in its own shared memory (a 256-byte staging area, then the keys);
# SYM_WARPS warps a block
SYM_WARP_MAX = source_define("esc_symbolic", "SYM_WARP_MAX")
SYM_WARPS = source_define("esc_symbolic", "SYM_WARPS")


class SymbolicShape(NamedTuple):
    """Launch shape of the fused ESC symbolic kernel
    (:func:`symbolic_shape`)."""

    warp_keys: int      # keys a short row's warp holds in shared memory
    smem_keys: int      # a long row's keys, or bitmask words, that shared
    #                     memory holds (-1: none, its table is in scratch)
    smem_bytes: int     # dynamic shared memory of a block
    slice_bytes: int    # each long-row block's scratch slice (0: none)
    long_blocks: int    # blocks that take the long rows (they loop)


@functools.lru_cache(maxsize=256)
def symbolic_shape(smem_limit: int, short_bound: int, long_bound: int,
                   max_deg_a_long: int, n_long: int,
                   ncols_b: int) -> SymbolicShape:
    """Kernel 2's launch shape, on a card with ``smem_limit`` bytes of
    opt-in shared memory a block, for short rows of at most
    ``short_bound`` products (0: none; at most :data:`SYM_WARP_MAX`) and
    ``n_long`` long rows of at most ``long_bound`` products whose bucket
    bounds on A are at most ``max_deg_a_long``, over B's ``ncols_b``
    columns.  A short row's warp holds exactly its bound's keys.  A long
    row's block holds its table (product prefix and B-row starts, 8 bytes
    an A entry) and then a region of ``smem_keys`` ints: its keys, or the
    bitmask of its column extent — as many ints as the largest long row
    has products, or as B has 32-column words, whichever is more, as far
    as shared memory goes.  A long row whose extent fits the region counts
    by bitmask; one whose keys fit it sorts there; any other counts in a
    scratch slice of ``long_bound`` ints, by bitmask where its extent fits
    the slice, else by a sort.  When not even the table and 32
    ints fit, ``smem_keys`` is -1 and table and keys live in the slice."""
    warp_keys = max(1, min(SYM_WARP_MAX, int(short_bound)))
    short_bytes = (SYM_WARPS * (256 + align16(4 * warp_keys))
                   if short_bound > 0 else 0)
    smem_keys, long_bytes, slice_bytes, long_blocks = 0, 0, 0, 0
    if n_long:
        long_bound = max(1, int(long_bound))
        table = 2 * align16(4 * (max_deg_a_long + 1))
        room = (smem_limit - STATIC_SMEM_RESERVE - table) // 4
        if room >= 32:
            smem_keys = min(room, max(long_bound, -(-int(ncols_b) // 32)))
            long_bytes = table + 4 * smem_keys
            slice_bytes = align16(4 * long_bound) if long_bound > smem_keys \
                else 0
        else:
            smem_keys = -1
            slice_bytes = align16(table + 4 * long_bound)
        long_blocks = (n_long if not slice_bytes else
                       max(1, min(n_long, SCRATCH_BYTES // slice_bytes)))
    return SymbolicShape(warp_keys, smem_keys, max(short_bytes, long_bytes),
                         slice_bytes, long_blocks)


class RowLaunch(NamedTuple):
    """One launch of a kernel whose blocks own a row each."""

    threads: int        # threads of a block
    tile_n: int         # columns of each warp's dense tile
    bins: int           # column ranges (bins) a row is partitioned into
    smem_pairs: int     # a row's pairs that shared memory holds (-1: none)
    smem_bytes: int     # dynamic shared memory of a block


class NumericShape(NamedTuple):
    """Launch shape of a numeric kernel whose workspaces follow a bound on
    the launched rows' products (:func:`esc_numeric_shape`,
    :func:`bin_numeric_shape`)."""

    launches: tuple     # RowLaunch per block launch, shortest rows first
    slice_bytes: int    # each block's scratch slice (0: no row needs one)
    slice_pairs: int    # pairs a slice holds
    warp_pairs: int = 0   # ESC: products a row's lane group sorts alone
    mid_pairs: int = 0    # ESC: rows past it go to the second launch
    group: int = 32       # ESC: lanes a short row takes (4 to 32)


# csrc/esc_numeric.cu's ESC_WARP_MAX
ESC_WARP_MAX = 1024
# Rows up to MID_PAIRS products run blocks of the first launch shape,
# longer rows (when the call's bound has them) the second: (threads, tile
# columns, column ranges) — for ESC, 256-thread blocks with 64 KB of pairs
# in shared memory (three an SM), then 1,024 threads for a hub row
MID_PAIRS = 8192
ESC_LAUNCHES = ((256, 512, 256), (1024, 256, 512))


def _ceil_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _row_tables(max_deg_a: int, warps: int, bins: int) -> int:
    """Bytes of a block row's tables: its product prefix, its A entries'
    B-row starts and values, the bins' starts and each warp's bin counts."""
    return (3 * align16(4 * (max_deg_a + 1)) + align16(4 * (bins + 1))
            + align16(4 * warps * bins))


def _tiles(warps: int, tile_n: int) -> int:
    """Bytes of the warps' dense tiles: floats and presence words."""
    return 4 * warps * (tile_n + tile_n // 32)


@functools.lru_cache(maxsize=256)
def esc_numeric_shape(smem_limit: int, max_deg_a: int,
                      bound: int) -> NumericShape:
    """Kernel 3's launch shape for rows of at most ``bound`` products each
    (4-byte column, 4-byte value), on a card with ``smem_limit`` bytes of
    opt-in shared memory a block.  Rows of up to ``warp_pairs`` products
    run a group of lanes each (``group``: two products a lane, 4 to 32
    lanes, so short rows share a warp); the rest a block: 256 threads for rows of up to
    :data:`MID_PAIRS` products, and, when ``bound`` passes that, a second
    launch of 1,024 threads for the longer rows (:data:`ESC_LAUNCHES`).  A
    block keeps its warps' dense tiles in shared memory, and places its
    tables (:func:`_row_tables`) and a row's pairs by
    :func:`split_workspace` in what remains: a row's pairs go to a scratch
    slice only when they do not fit beside the tables."""
    bound = max(0, int(bound))
    launches, tables, slice_bytes = (), 0, 0
    for (threads, tile_n, bins), pairs in zip(
            ESC_LAUNCHES, (min(bound, MID_PAIRS), bound)):
        if launches and bound <= MID_PAIRS:
            break
        tiles = _tiles(threads // 32, tile_n)
        t = _row_tables(max_deg_a, threads // 32, bins)
        smem_pairs, ws, slice_t = split_workspace(smem_limit - tiles, t, 8,
                                                  pairs)
        launches += (RowLaunch(threads, tile_n, bins, smem_pairs,
                               tiles + ws),)
        tables, slice_bytes = max(tables, t), max(slice_bytes, slice_t)
    # a slice holds the tables too, for a launch whose tables are not in
    # shared memory
    warp_pairs = max(1, min(ESC_WARP_MAX, bound))
    return NumericShape(launches,
                        align16(tables + 8 * bound) if slice_bytes else 0,
                        bound if slice_bytes else 0, warp_pairs, MID_PAIRS,
                        min(32, max(4, _ceil_pow2(warp_pairs) // 2)))


@functools.lru_cache(maxsize=256)
def bin_numeric_shape(smem_limit: int, max_deg_a: int, bound: int,
                      tile_n: int, n_bins: int) -> NumericShape:
    """Kernel 6's launch shape for rows of at most ``bound`` products each:
    a block of 256 threads a row, 1,024 when ``bound`` passes
    :data:`MID_PAIRS`; the warps' dense tiles always in shared memory; the
    tables
    (:func:`_row_tables` over ``n_bins`` bins) and the row's binned pairs
    (8 bytes each) placed by :func:`split_workspace` in what remains."""
    bound = max(0, int(bound))
    threads = 256 if bound <= MID_PAIRS else 1024
    tiles = _tiles(threads // 32, tile_n)
    tables = _row_tables(max_deg_a, threads // 32, n_bins)
    smem_pairs, ws_bytes, slice_bytes = split_workspace(
        smem_limit - tiles, tables, 8, bound)
    return NumericShape((RowLaunch(threads, tile_n, n_bins, smem_pairs,
                                   tiles + ws_bytes),),
                        align16(slice_bytes), bound if slice_bytes else 0)
