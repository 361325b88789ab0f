"""Load balance from predicted output structure (paper Section I / DESIGN §3).

The paper bins CPU rows by FLOP; at pod scale the analogous decision is which
*device shard* owns which row range.  Balancing on the **predicted nnz per
row** (not FLOP) equalizes accumulation work and output bytes — FLOP-balanced
partitions are skewed by exactly the compression ratio the paper predicts.

Host-side (numpy): partitioning is a launch-time decision.  A copy of the
JAX package's module; the single-device panel plans use
:func:`column_panels`, the rest waits for the port's distributed plans.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    bounds: np.ndarray        # int64 (num_parts+1,) row-range boundaries
    part_weight: np.ndarray   # float64 (num_parts,)
    imbalance: float          # max part weight / mean part weight

    @property
    def num_parts(self) -> int:
        return len(self.part_weight)


def balanced_contiguous(weights: np.ndarray, num_parts: int) -> Partition:
    """Contiguous row ranges with ~equal total weight (prefix-split)."""
    w = np.asarray(weights, dtype=np.float64)
    cum = np.cumsum(w)
    total = cum[-1] if cum.size else 0.0
    targets = total * (np.arange(1, num_parts) / num_parts)
    inner = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], inner, [w.size]]).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)  # monotone even for degenerate w
    pw = np.add.reduceat(w, bounds[:-1]) if w.size else np.zeros(num_parts)
    pw = pw * (np.diff(bounds) > 0)  # empty parts weigh nothing
    mean = total / num_parts if num_parts else 1.0
    imb = float(pw.max() / mean) if total > 0 else 1.0
    return Partition(bounds=bounds, part_weight=pw, imbalance=imb)


# --------------------------------------------------------------------------- #
# Column panels (DESIGN.md §8): the output column space of C = A·B is split
# into contiguous panels of B columns so the distributed numeric phase can
# lay B out along a second (or folded) mesh axis instead of replicating it.
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PanelPartition:
    """Contiguous column panels of B: ``[edges[p], edges[p+1])`` per panel."""

    edges: np.ndarray         # int64 (n_panels+1,) column boundaries, 0..ncols
    panel_nnz: np.ndarray     # int64 (n_panels,) B entries per panel
    quantized: bool = False   # edges snapped to the pow2 grid (cache-stable)

    @property
    def n_panels(self) -> int:
        return int(self.edges.size - 1)

    @property
    def key(self) -> tuple:
        """Hashable static half — part of the panel plan-cache key."""
        return (self.n_panels, self.quantized,
                tuple(int(e) for e in self.edges))

    def panel_of(self, cols: np.ndarray) -> np.ndarray:
        """Column id → owning panel index."""
        return np.searchsorted(self.edges, np.asarray(cols), side="right") - 1


def panel_grid(ncols: int, n_panels: int) -> int:
    """The pow2 edge grid quantized panel boundaries snap to.

    Coarse enough that same-family different-seed edge jitter collapses onto
    one grid point (cache-stable keys), fine enough (≤ ~1/8 of a panel, the
    snap is half a grid step) that snapping cannot materially unbalance the
    panels."""
    from .binning import floor_pow2
    return max(1, floor_pow2(max(1, ncols // (4 * max(1, n_panels)))))


def quantize_panel_edges(edges: np.ndarray, ncols: int) -> np.ndarray:
    """Snap interior panel edges to the pow2 grid (endpoints fixed).

    Two edge lists collide after quantization **iff** every interior edge
    pair falls in the same grid band (nearest grid point) — the panel half
    of the plan-cache quantization contract (``tests/test_panels.py``).
    Monotonicity is preserved; degenerate inputs may yield empty panels,
    which execute as no-ops."""
    edges = np.asarray(edges, dtype=np.int64)
    g = panel_grid(ncols, edges.size - 1)
    inner = np.clip((edges[1:-1] + g // 2) // g * g, 0, ncols)
    out = np.concatenate([edges[:1], inner, edges[-1:]])
    return np.maximum.accumulate(out)


def column_panels(b, n_panels: int, *, quantize: bool = False
                  ) -> PanelPartition:
    """Split B's column space into ``n_panels`` contiguous panels with
    ~equal B nnz per panel (prefix-split over per-column counts, the column
    analogue of :func:`balanced_contiguous`).

    ``quantize`` snaps the interior edges to the pow2 grid so same-family
    different-seed matrices land on identical panel keys (the §7 plan-cache
    quantization knob, extended to panels)."""
    if int(n_panels) < 1:
        from .errors import PlanMismatchError
        raise PlanMismatchError(
            f"column_panels needs n_panels >= 1, got {n_panels}",
            observed=int(n_panels), planned=1)
    ncols = int(b.shape[1])
    counts = np.bincount(np.asarray(b.col, dtype=np.int64),
                         minlength=max(1, ncols)).astype(np.float64)
    cum = np.cumsum(counts[:ncols]) if ncols else np.zeros(0)
    total = cum[-1] if cum.size else 0.0
    targets = total * (np.arange(1, n_panels) / n_panels)
    # edge e means panel boundary BEFORE column e: prefix nnz of cols < e
    inner = np.searchsorted(cum, targets, side="left") + 1 if ncols else \
        np.zeros(n_panels - 1, dtype=np.int64)
    edges = np.concatenate([[0], np.minimum(inner, ncols),
                            [ncols]]).astype(np.int64)
    edges = np.maximum.accumulate(edges)
    if quantize:
        edges = quantize_panel_edges(edges, ncols)
    pnnz = np.zeros(n_panels, dtype=np.int64)
    for p in range(n_panels):
        lo, hi = int(edges[p]), int(edges[p + 1])
        pnnz[p] = int(cum[hi - 1] - (cum[lo - 1] if lo else 0.0)) if hi > lo \
            else 0
    return PanelPartition(edges=edges, panel_nnz=pnnz,
                          quantized=bool(quantize))


def static_row_assignment(part: Partition, rows_per_part: int) -> np.ndarray:
    """(num_parts, rows_per_part) row-id table, padded by repeating the last
    row of each range — the static-shape input a sharded executor needs."""
    out = np.zeros((part.num_parts, rows_per_part), dtype=np.int32)
    for i in range(part.num_parts):
        lo, hi = int(part.bounds[i]), int(part.bounds[i + 1])
        n = hi - lo
        if n == 0:
            out[i] = 0
            continue
        ids = np.arange(lo, hi, dtype=np.int32)
        if n >= rows_per_part:
            out[i] = ids[:rows_per_part]
        else:
            out[i, :n] = ids
            out[i, n:] = ids[-1]
    return out


def shard_slices(sorted_rows: np.ndarray,
                 bounds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-part ``[lo, hi)`` index ranges of an ascending row-id list under
    contiguous row-range ``bounds`` (len num_parts+1).

    ``sorted_rows[lo[s]:hi[s]]`` are exactly the listed rows owned by part
    ``s`` — the bucket∩shard intersection the unified planner (``core.plan``)
    uses to build per-bucket shard tables.
    """
    r = np.asarray(sorted_rows)
    b = np.asarray(bounds)
    lo = np.searchsorted(r, b[:-1], side="left")
    hi = np.searchsorted(r, b[1:], side="left")
    return lo, hi


def binned_cost_weights(plan) -> np.ndarray:
    """Per-row cost model under binned execution (``core.binning``): a row
    costs its bucket's padded buffer width, not its own degree — the buffer
    is what the device actually streams.  Feed to ``balanced_contiguous`` to
    balance shards for the binned pipeline."""
    w = np.zeros(plan.nrows, dtype=np.float64)
    for b in plan.buckets:
        w[b.rows] = float(b.width)
    return w


def straggler_report(part_flop: Partition, part_pred: Partition) -> dict:
    """Compare FLOP-balanced vs predicted-NNZ-balanced imbalance (the paper's
    load-balance claim, measured as the straggler factor a pod would see)."""
    return dict(
        flop_balanced_imbalance=part_flop.imbalance,
        predicted_nnz_balanced_imbalance=part_pred.imbalance,
        straggler_speedup=part_flop.imbalance / max(part_pred.imbalance, 1e-9),
    )
