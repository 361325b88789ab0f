"""Degree-aware row binning — the execution planner for both phases.

A copy of ``repro.core.binning`` (the port imports nothing of ``repro``),
so that both packages bucket the same rows under the same bounds.

Motivation (DESIGN.md §4): expanding each processed row into a
``(rows, DA·DB)`` gather/sort buffer sized by the *global* max row degrees
lets one hub row of a power-law matrix inflate the buffer quadratically for
**every** row.  The standard SpGEMM fix (Liu & Vinter, arXiv:1504.05022) is
to bucket rows by the size of their intermediate product set and run each
bucket with buffers sized for *that* bucket:

  * every output row ``i`` gets a width ``w_i = max(1, deg_a_i · dbmax_i)``
    where ``dbmax_i`` is the largest B-row degree among the B rows the row
    references — the exact lane count its gather/sort buffer needs;
  * rows are partitioned into pow2 buckets by ``ceil_pow2(w_i)``; buckets
    with fewer than ``min_rows`` rows are coalesced upward so tiny buckets
    don't fragment the work into many kernel launches;
  * each bucket carries a static plan ``(rows, deg_a, deg_b, block_rows)``:
    ``deg_a``/``deg_b`` are the bucket's exact max degrees by default
    (``deg_align > 1`` opts into quantized bounds, see :func:`round_deg`).
    ``block_rows`` keeps ``block_rows · next_pow2(deg_a·deg_b)`` under
    ``lane_budget``; it sized the JAX package's kernel blocks, and the
    port's kernels ignore it (outputs do not depend on it), but it stays in
    the plan so that both packages' plans are identical;
  * each bucket is stamped with an accumulator ``route`` (DESIGN.md §5):
    ``"esc"`` (sort), ``"spa"`` (dense accumulator) or ``"bin"``
    (propagation blocking), chosen by the :func:`route_costs` model.

``RowBucket.signature`` is the static half of a bucket's executor key;
``BinningPlan.signatures()`` exposes the set.
"""
from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_LANE_BUDGET = 1 << 17   # lanes per block: BS·F2 ≤ budget
DEFAULT_MAX_BLOCK_ROWS = 256
DEFAULT_MIN_ROWS = 32           # coalesce buckets smaller than this

# Accumulator routes (DESIGN.md §5, §11).  ESC = expand/sort/compress: the
# bitonic sort + adjacent-unique (symbolic) / segmented run-sum (numeric)
# backend.  SPA = accumulator backend: bitmask-popcount distinct count
# (symbolic) and a dense column-tiled scatter accumulator (numeric).  BIN =
# propagation-blocking (arXiv:2002.11302): partial products are gathered once
# and emitted into per-column-panel bins of width ``tile_n``, each merged with
# a dense-SPA pass — one gather instead of SPA's per-tile re-gather, so it
# wins exactly where wide column spans make SPA's grid re-traversal the cost.
ROUTE_ESC = "esc"
ROUTE_SPA = "spa"
ROUTE_BIN = "bin"
ROUTES = (ROUTE_ESC, ROUTE_SPA, ROUTE_BIN)

SPA_MIN_TILE = 128              # one VPU lane row — never tile finer
BIN_TILE = 256                  # bin width: sequential-write granularity

# ``round_deg`` align sentinel: any align ≥ the degree collapses the rule to
# pure pow2 rounding (``d <= align`` branch) — the degree-bound half of the
# population-quantization knob (``plan_spgemm(pop_quant=True)``).
POW2_DEG_ALIGN = 1 << 60
DEFAULT_SPA_MIN_BLOCK_ROWS = 64  # auto-route gate: dense tiles need tall
                                 # blocks to amortize the per-tile touch


def ceil_pow2(n: int) -> int:
    """Smallest power of two ≥ max(1, n)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def floor_pow2(n: int) -> int:
    """Largest power of two ≤ max(1, n)."""
    return 1 << (max(1, int(n)).bit_length() - 1)


def round_deg(d: int, align: int = 1) -> int:
    """Degree bound rounding.  ``align=1`` keeps the exact bucket maximum —
    binned lanes are then ≤ global lanes for every row, by construction.
    Larger ``align`` quantizes (pow2 below ``align``, then multiples of it),
    trading ≤ ~1/align buffer inflation for a smaller signature set that
    executor-key-shares across differently-shaped matrices."""
    d = max(1, int(d))
    if align <= 1:
        return d
    if d <= align:
        return ceil_pow2(d)
    return ((d + align - 1) // align) * align


@dataclasses.dataclass(frozen=True)
class RowBucket:
    """One degree bucket: static shapes + the row ids that run under them."""

    rows: np.ndarray      # int32 (n,) output-row ids, ascending
    deg_a: int            # bound on A-row degree within the bucket
    deg_b: int            # bound on referenced-B-row degree
    block_rows: int       # grid block height for this bucket's kernels
    route: str = ROUTE_ESC  # accumulator backend: "esc", "spa" or "bin"
    tile_n: int = 0       # SPA column tile / BIN bin width (0 on esc)
    n_tiles: int = 0      # SPA tile count / BIN bin count (0 on esc)
    span: int = 0         # bound on per-row product-column extent (0 = ncols)

    @property
    def n_rows(self) -> int:
        return int(self.rows.size)

    @property
    def width(self) -> int:
        """Gather-buffer lanes per row (before kernel pow2 rounding)."""
        return self.deg_a * self.deg_b

    @property
    def lanes(self) -> int:
        """Total expanded-buffer lanes this bucket processes."""
        return self.n_rows * self.width

    @property
    def signature(self) -> tuple[int, int, int, str, int, int]:
        """The static shape tuple device executors specialize on."""
        return (self.deg_a, self.deg_b, self.block_rows, self.route,
                self.tile_n, self.span)


@dataclasses.dataclass(frozen=True)
class BinningPlan:
    """Partition of all output rows into degree buckets."""

    buckets: tuple[RowBucket, ...]
    nrows: int
    global_deg_a: int         # the global-pad bounds the plan replaces
    global_deg_b: int
    row_bucket: np.ndarray    # int32 (nrows,) row → bucket index

    @property
    def lanes(self) -> int:
        """Expanded-buffer lanes processed by the binned pipeline."""
        return sum(b.lanes for b in self.buckets)

    @property
    def global_lanes(self) -> int:
        """Lanes the global-pad pipeline processes for the same rows."""
        return self.nrows * max(1, self.global_deg_a * self.global_deg_b)

    @property
    def lane_reduction(self) -> float:
        """How many× fewer lanes the binned pipeline touches (≥ 1 good)."""
        return self.global_lanes / max(1, self.lanes)

    def signatures(self) -> tuple[tuple[int, int, int, str, int, int], ...]:
        """Sorted unique bucket signatures — the executor-key set."""
        return tuple(sorted({b.signature for b in self.buckets}))

    def route_rows(self) -> dict:
        """Rows per accumulator route — the planner's routing decision."""
        out = {r: 0 for r in ROUTES}
        for b in self.buckets:
            out[b.route] += b.n_rows
        return out

    def inverse_perm(self) -> np.ndarray:
        """Permutation restoring row-id order from bucket-concatenation order.

        Buckets partition the rows, so ``concat(per-bucket results)[perm]``
        assembles a full per-row array without per-bucket scatter copies —
        the shared assembly idiom of the binned executors."""
        return np.argsort(
            np.concatenate([b.rows for b in self.buckets])
            if self.buckets else np.zeros(0, np.int32), kind="stable")

    def subset(self, rows: np.ndarray) -> list[np.ndarray]:
        """Bucket an arbitrary row list (e.g. the sampled rows) under this
        plan — entry ``i`` holds the rows of ``rows`` that live in bucket
        ``i`` (duplicates preserved: sampling is with replacement)."""
        rows = np.asarray(rows, dtype=np.int64)
        which = self.row_bucket[rows]
        return [np.ascontiguousarray(rows[which == i].astype(np.int32))
                for i in range(len(self.buckets))]

    def stats(self) -> dict:
        return dict(
            num_buckets=len(self.buckets),
            lanes_binned=self.lanes,
            lanes_global=self.global_lanes,
            lane_reduction=round(self.lane_reduction, 3),
            signatures=[list(s) for s in self.signatures()],
            bucket_rows=[b.n_rows for b in self.buckets],
            bucket_widths=[b.width for b in self.buckets],
            bucket_routes=[b.route for b in self.buckets],
            route_rows=self.route_rows(),
        )


def _pick_block_rows(width: int, lane_budget: int, max_block_rows: int) -> int:
    """Largest pow2 block height with block·F2 lanes under the lane budget."""
    f2 = ceil_pow2(width)
    fit = max(1, lane_budget // f2)
    blk = 1 << (fit.bit_length() - 1)          # floor to pow2
    return int(max(1, min(max_block_rows, blk)))


# --------------------------------------------------------------------------- #
# Accumulator routing (DESIGN.md §5): sort/ESC vs bitmask/dense-SPA per bucket.
# --------------------------------------------------------------------------- #
def row_spans(a_rpt: np.ndarray, a_col: np.ndarray, b_rpt: np.ndarray,
              b_col: np.ndarray) -> np.ndarray:
    """Per-output-row product-column extent ``hi - lo + 1`` (≥ 1).

    The SPA kernels address their bitmask words / dense tile relative to
    each row's minimum product column, so their static lane count is the
    bucket's worst *extent*, not ``ncols_b`` — for banded/FEM structure the
    extent is the band width, orders of magnitude below the column count.
    Rows with no products get extent 1.
    """
    a_rpt = np.asarray(a_rpt, dtype=np.int64)
    a_col = np.asarray(a_col, dtype=np.int64)
    b_rpt = np.asarray(b_rpt, dtype=np.int64)
    b_col = np.asarray(b_col, dtype=np.int64)
    m = a_rpt.size - 1
    mb = b_rpt.size - 1
    big = np.int64(np.iinfo(np.int32).max)
    b_lo = np.full(mb, big)
    b_hi = np.full(mb, -1, dtype=np.int64)
    ne_b = np.diff(b_rpt) > 0
    if b_rpt[-1]:
        starts = b_rpt[:-1][ne_b]
        b_lo[ne_b] = np.minimum.reduceat(b_col[: b_rpt[-1]], starts)
        b_hi[ne_b] = np.maximum.reduceat(b_col[: b_rpt[-1]], starts)
    lo = np.full(m, big)
    hi = np.full(m, -1, dtype=np.int64)
    ne_a = np.diff(a_rpt) > 0
    if a_rpt[-1]:
        ks = np.clip(a_col[: a_rpt[-1]], 0, mb - 1)
        starts = a_rpt[:-1][ne_a]
        lo[ne_a] = np.minimum.reduceat(b_lo[ks], starts)
        hi[ne_a] = np.maximum.reduceat(b_hi[ks], starts)
    return np.maximum(1, hi - lo + 1)


def spa_tile(span: int, lane_budget: int) -> tuple[int, int]:
    """SPA dense-accumulator column tiling: ``(tile_n, n_tiles)``.

    One tile covering the pow2-padded column *extent* when it fits the
    lane budget (with at least a minimal block height), else the largest
    pow2 tile that does; ``n_tiles`` tiles then cover ``next_pow2(span)``
    exactly.
    """
    n_pad = ceil_pow2(max(1, int(span)))
    cap = max(SPA_MIN_TILE, floor_pow2(max(1, lane_budget // 8)))
    tile = min(max(n_pad, SPA_MIN_TILE), cap)
    return tile, -(-n_pad // tile)


def bin_tile(span: int, lane_budget: int) -> tuple[int, int]:
    """Propagation-blocking bin layout: ``(tile_n, n_bins)``.

    Bins are narrow fixed-width column panels (:data:`BIN_TILE` lanes, floored
    at :data:`SPA_MIN_TILE`) covering ``next_pow2(span)`` exactly — the kernel
    gathers the product buffer ONCE and streams it into all bins, so unlike
    :func:`spa_tile` the width is not pushed up toward the lane cap: small
    bins are what makes the per-bin merge a cheap dense pass.
    """
    n_pad = ceil_pow2(max(1, int(span)))
    cap = max(SPA_MIN_TILE, floor_pow2(max(1, lane_budget // 8)))
    tile = min(max(n_pad, SPA_MIN_TILE), BIN_TILE, cap)
    return tile, -(-n_pad // tile)


def route_costs(deg_a: int, deg_b: int, ncols_b: int, span: int | None = None,
                lane_budget: int = DEFAULT_LANE_BUDGET) -> dict:
    """Per-row lane-op cost model deciding a bucket's accumulator route.

    ESC pays the bitonic network over the pow2-rounded gather width ``F2``
    in both phases — ``~3·w·log2²(F2)`` lane-ops (symbolic sort + the
    pricier key/value sort of the numeric phase).  SPA pays the
    broadcast-compare accumulation against its column extent: ``w`` products
    each checked against ``extent/32`` bitmask words (symbolic) and
    ``extent`` dense tile lanes (numeric), plus the tile touch itself.
    BIN gathers once and streams each product into one fixed-width bin: per
    product one bin-id select over ``n_bins`` bins, one ``tile``-lane dense
    accumulate, ``tile/32`` presence words, plus the bin-buffer touch —
    linear in extent like SPA but without SPA's per-tile product re-gather
    (the ``w·cols`` term that sinks SPA on wide spans).  Constant factors
    are coarse — the regimes the router must separate (banded/FEM extent ≪
    log²w·32 vs ER/power-law extent ≈ ncols) differ by well over 2×.
    """
    w = max(1, int(deg_a) * int(deg_b))
    f2 = ceil_pow2(w)
    lg = max(1, f2.bit_length() - 1)
    span = int(ncols_b if span is None else min(span, ncols_b))
    tile_n, n_tiles = spa_tile(span, lane_budget)
    cols = n_tiles * tile_n
    spa = w * (cols + -(-cols // 32)) + cols
    btile, bn = bin_tile(span, lane_budget)
    binc = w * (btile + bn + -(-btile // 32)) + bn * btile
    return dict(esc=3 * w * lg * lg, spa=spa, bin=binc,
                tile_n=tile_n, n_tiles=n_tiles,
                bin_tile=btile, bin_n=bn, span=span)


def choose_route(deg_a: int, deg_b: int, ncols_b: int, span: int | None = None,
                 *, lane_budget: int = DEFAULT_LANE_BUDGET,
                 spa_min_block_rows: int = DEFAULT_SPA_MIN_BLOCK_ROWS,
                 profile=None) -> tuple[str, int, int]:
    """``(route, tile_n, n_tiles)`` for one bucket's static bounds.

    Candidates are gated structurally, then the cheapest wins (strict ``<``
    displacement, ESC first — ties keep the sort path):

    * SPA is a candidate iff the dense tile leaves at least
      ``spa_min_block_rows`` rows per kernel block under the lane budget —
      a wide accumulator shared by only a handful of rows spends its time
      touching the tile, not accumulating;
    * BIN is a candidate iff the layout yields ≥ 2 bins — with a single bin
      propagation blocking degenerates to SPA's dense pass.

    ``profile`` (a :class:`repro_torch.core.profiles.RouteProfile`) replaces
    the analytic :func:`route_costs` numbers with measured per-row seconds
    when it covers every surviving candidate; the structural gates above
    are applied either way, and any uncovered route falls the whole
    comparison back to the analytic model (cold-start rule, DESIGN.md §11).
    """
    c = route_costs(deg_a, deg_b, ncols_b, span, lane_budget)
    w = max(1, int(deg_a) * int(deg_b))
    cands = [(ROUTE_ESC, 0, 0, c["esc"])]
    spa_block = floor_pow2(max(1, lane_budget // c["tile_n"]))
    if spa_block >= spa_min_block_rows:
        cands.append((ROUTE_SPA, c["tile_n"], c["n_tiles"], c["spa"]))
    if c["bin_n"] >= 2:
        cands.append((ROUTE_BIN, c["bin_tile"], c["bin_n"], c["bin"]))
    if profile is not None:
        measured = [profile.route_seconds(r, w, c["span"])
                    for (r, _, _, _) in cands]
        if all(s is not None for s in measured):
            cands = [(r, t, n, s)
                     for (r, t, n, _), s in zip(cands, measured)]
    best = cands[0]
    for cand in cands[1:]:
        if cand[3] < best[3]:
            best = cand
    return best[0], best[1], best[2]


def row_widths(a_rpt: np.ndarray, a_col: np.ndarray,
               rownnz_b: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-output-row (deg_a, dbmax, width) from host CSR index arrays."""
    a_rpt = np.asarray(a_rpt, dtype=np.int64)
    a_col = np.asarray(a_col, dtype=np.int64)
    rownnz_b = np.asarray(rownnz_b, dtype=np.int64)
    m = a_rpt.size - 1
    nnz = int(a_rpt[-1])
    deg_a = np.diff(a_rpt)
    # max referenced-B degree per row: maximum.reduceat over the CSR slices
    per_nnz = rownnz_b[np.clip(a_col[:nnz], 0, rownnz_b.size - 1)]
    dbmax = np.zeros(m, dtype=np.int64)
    nonempty = deg_a > 0
    if nnz:
        starts = a_rpt[:-1][nonempty]
        dbmax[nonempty] = np.maximum.reduceat(per_nnz, starts)
    width = np.maximum(1, deg_a * dbmax)
    return deg_a, dbmax, width



def panel_row_tables(a_rpt: np.ndarray, a_col: np.ndarray,
                     panel_rpts) -> tuple[np.ndarray, np.ndarray]:
    """Per-panel per-output-row degree tables for column-partitioned B.

    ``panel_rpts`` is one CSR row-pointer array per column panel of B (the
    panel slices share B's row ids; only the entries are split).  Returns
    ``(dbmax, flopr)``, each ``(n_panels, m)``:

      * ``dbmax[p, i]`` — the largest *panel-p* degree among the B rows that
        output row ``i`` references: the per-panel gather bound that
        replaces the full-row ``dbmax`` of :func:`row_widths`;
      * ``flopr[p, i]`` — row ``i``'s FLOP restricted to panel ``p``
        (Algorithm 1 per panel); panels partition B's entries, so
        ``flopr.sum(axis=0)`` equals the full-row FLOP exactly.

    Computed once from the panel slices and reused by capacity planning,
    the numeric kernels' FLOP bounds and the exact fallback (DESIGN.md §8).
    """
    a_rpt = np.asarray(a_rpt, dtype=np.int64)
    a_col = np.asarray(a_col, dtype=np.int64)
    m = a_rpt.size - 1
    nnz = int(a_rpt[-1])
    n_panels = len(panel_rpts)
    dbmax = np.zeros((n_panels, m), dtype=np.int64)
    flopr = np.zeros((n_panels, m), dtype=np.int64)
    nonempty = np.diff(a_rpt) > 0
    starts = a_rpt[:-1][nonempty]
    for p, prpt in enumerate(panel_rpts):
        rownnz_p = np.diff(np.asarray(prpt, dtype=np.int64))
        if not nnz:
            continue
        per = rownnz_p[np.clip(a_col[:nnz], 0, rownnz_p.size - 1)]
        dbmax[p, nonempty] = np.maximum.reduceat(per, starts)
        flopr[p, nonempty] = np.add.reduceat(per, starts)
    return dbmax, flopr

def build_plan(a, b, *, lane_budget: int = DEFAULT_LANE_BUDGET,
               max_block_rows: int = DEFAULT_MAX_BLOCK_ROWS,
               min_rows: int = DEFAULT_MIN_ROWS,
               deg_align: int = 1, route: str = "auto",
               spa_min_block_rows: int = DEFAULT_SPA_MIN_BLOCK_ROWS
               ) -> BinningPlan:
    """Plan the binned execution of ``C = A·B``.

    ``a``/``b`` are host ``CSR`` — only the int index arrays are read
    (planning is a launch-time host step).

    ``route`` selects the accumulator backend per bucket: ``"auto"`` applies
    the :func:`choose_route` cost model (consulting the active measured
    profile from :mod:`repro_torch.core.profiles` when one is set);
    ``"esc"``/``"spa"``/``"bin"`` force every bucket onto one backend
    (forced SPA/BIN fall back to column tiling instead of being rejected by
    the lane-budget gate — outputs are route-invariant either way, see DESIGN.md
    §5/§11).
    """
    if route not in ("auto",) + ROUTES:
        from .errors import PlanMismatchError
        raise PlanMismatchError(f"unknown route {route!r}")
    profile = None
    if route == "auto":
        from . import profiles as profiles_mod   # lazy: profiles times plans
        profile = profiles_mod.active()
    a_rpt = np.asarray(a.rpt)
    a_col = np.asarray(a.col)
    b_rpt = np.asarray(b.rpt)
    rownnz_b = np.diff(b_rpt.astype(np.int64))
    deg_a, dbmax, width = row_widths(a_rpt, a_col, rownnz_b)
    m = deg_a.size

    # pow2 bucket key per row → ascending width groups (≤ ~log2(max_width))
    key = np.ceil(np.log2(np.maximum(width, 1))).astype(np.int64)
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    _, starts_u, counts = np.unique(sorted_key, return_index=True,
                                    return_counts=True)
    groups = [order[s0:s0 + c] for s0, c in zip(starts_u, counts)]

    def bounds(ids):
        da = round_deg(int(deg_a[ids].max()), deg_align) if ids.size else 1
        db = round_deg(int(dbmax[ids].max()), deg_align) if ids.size else 1
        return da, db

    # Coalesce, ascending, and ONLY ever upward: a small group rides along
    # with the next larger-width bucket (a few rows pay a wider buffer).
    # Never merge downward — pulling one hub bucket into a big small-width
    # group would re-inflate every row to hub width, which is exactly the
    # pathology binning exists to remove.  Adjacent groups whose degree
    # bounds coincide merge for free (same executor either way).
    merged: list[np.ndarray] = []
    carry: np.ndarray | None = None
    for ids in groups:
        if carry is not None:
            ids = np.concatenate([carry, ids])
            carry = None
        if merged and bounds(np.concatenate([merged[-1], ids])) == bounds(merged[-1]):
            merged[-1] = np.concatenate([merged[-1], ids])
        elif ids.size < min_rows:
            carry = ids
        else:
            merged.append(ids)
    if carry is not None:
        if merged and bounds(np.concatenate([merged[-1], carry])) == bounds(merged[-1]):
            merged[-1] = np.concatenate([merged[-1], carry])
        else:
            merged.append(carry)        # trailing hub bucket stays isolated

    ncols_b = int(b.shape[1])
    # forced-ESC plans never read extents — skip the O(nnz) host pass
    spans = (row_spans(a_rpt, a_col, b_rpt, np.asarray(b.col))
             if route != ROUTE_ESC else None)
    buckets = []
    row_bucket = np.zeros(m, dtype=np.int32)
    for i, ids in enumerate(merged):
        ids = np.sort(ids).astype(np.int32)
        da, db = bounds(ids)
        # pow2-rounded extent bound: stable across same-family matrices, so
        # span does not fragment the signature (executor-key) set
        span = min(ceil_pow2(int(spans[ids].max()))
                   if spans is not None and ids.size else 1,
                   ceil_pow2(ncols_b))
        blk = _pick_block_rows(da * db, lane_budget, max_block_rows)
        if route == ROUTE_ESC:
            rt, tile, ntiles = ROUTE_ESC, 0, 0
        elif route == ROUTE_SPA:
            rt = ROUTE_SPA
            tile, ntiles = spa_tile(span, lane_budget)
        elif route == ROUTE_BIN:
            rt = ROUTE_BIN
            tile, ntiles = bin_tile(span, lane_budget)
        else:
            rt, tile, ntiles = choose_route(
                da, db, ncols_b, span, lane_budget=lane_budget,
                spa_min_block_rows=spa_min_block_rows, profile=profile)
        if rt == ROUTE_SPA:
            # the block must also hold the dense column tile under the budget
            blk = int(max(1, min(blk, floor_pow2(
                max(1, lane_budget // tile)))))
        elif rt == ROUTE_BIN:
            # bin blocks hold ALL bins at once (one gather, stream to bins)
            blk = int(max(1, min(blk, floor_pow2(
                max(1, lane_budget // (tile * ntiles))))))
        else:
            span = 0                 # ESC kernels never specialize on extent
        buckets.append(RowBucket(rows=ids, deg_a=da, deg_b=db, block_rows=blk,
                                 route=rt, tile_n=tile, n_tiles=ntiles,
                                 span=span))
        row_bucket[ids] = i

    gda = int(deg_a.max()) if m else 1
    gdb = int(rownnz_b.max()) if rownnz_b.size else 1
    return BinningPlan(buckets=tuple(buckets), nrows=m,
                       global_deg_a=max(1, gda), global_deg_b=max(1, gdb),
                       row_bucket=row_bucket)
