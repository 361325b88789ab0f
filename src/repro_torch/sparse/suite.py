"""The 25-matrix evaluation suite and the 625-pair test-case factory.

Mirrors the paper's Section VI protocol: 25 matrices with a wide compression-
ratio spread (Table II: CR(A^2) in [1.01, 28.34], rows 13k..16.7M, uniform /
power-law / banded-FEM structure), multiplied pairwise (25x25 = 625 cases)
with the paper's dimension-matching reshape rule.

Sizes are scaled to laptop/CI class (rows 20k..120k) so the full 625-case
reproduction runs in minutes on one CPU core, while keeping every matrix big
enough that sample_num = min(0.003*M, 300) stays in the paper's regime
(60..300 sampled rows).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from .formats import CSR, match_dims
from . import random as sprand


@dataclasses.dataclass(frozen=True)
class SuiteEntry:
    name: str
    family: str
    build: Callable[[], CSR]


def _e(name: str, family: str, fn: Callable[[], CSR]) -> SuiteEntry:
    return SuiteEntry(name, family, fn)


# --------------------------------------------------------------------------- #
# 25 matrices.  Families and target CR(A^2) bands follow Table II:
#   er_*        CR ~ 1.0-1.6   (m133-b3, mc2depi, patents_main analogues)
#   pl_*        CR ~ 1.1-2.0   (webbase-1M, scircuit analogues)
#   rmat_*      CR ~ 1.8-3.0   (delaunay/cage analogues)
#   band_*      CR ~ 3-8       (offshore, filter3D, conf5 analogues)
#   fem_*       CR ~ 12-30     (cant, hood, consph, pwtk, pdb1HYS analogues)
# --------------------------------------------------------------------------- #
SUITE: tuple[SuiteEntry, ...] = (
    _e("er_120k_d3",    "er",   lambda: sprand.erdos_renyi(120_000, 120_000, 3, seed=101)),
    _e("er_100k_d4",    "er",   lambda: sprand.erdos_renyi(100_000, 100_000, 4, seed=102)),
    _e("er_80k_d6",     "er",   lambda: sprand.erdos_renyi(80_000, 80_000, 6, seed=103)),
    _e("er_60k_d8",     "er",   lambda: sprand.erdos_renyi(60_000, 60_000, 8, seed=104)),
    _e("er_40k_d12",    "er",   lambda: sprand.erdos_renyi(40_000, 40_000, 12, seed=105)),
    _e("pl_100k_d4",    "pl",   lambda: sprand.power_law(100_000, 100_000, 4, 1.8, seed=201)),
    _e("pl_80k_d6",     "pl",   lambda: sprand.power_law(80_000, 80_000, 6, 1.6, seed=202)),
    _e("pl_60k_d8",     "pl",   lambda: sprand.power_law(60_000, 60_000, 8, 1.5, seed=203)),
    _e("pl_40k_d10",    "pl",   lambda: sprand.power_law(40_000, 40_000, 10, 1.4, seed=204)),
    _e("rmat_80k",      "rmat", lambda: sprand.rmat(80_000, 80_000, 400_000, seed=301, a=0.5, b=0.2, c=0.2)),
    _e("rmat_60k",      "rmat", lambda: sprand.rmat(60_000, 60_000, 300_000, seed=302, a=0.5, b=0.2, c=0.2)),
    _e("rmat_40k",      "rmat", lambda: sprand.rmat(40_000, 40_000, 200_000, seed=303, a=0.5, b=0.2, c=0.2)),
    _e("band_60k_d16",  "band", lambda: sprand.banded(60_000, 60_000, 16, 24, seed=401)),
    _e("band_50k_d20",  "band", lambda: sprand.banded(50_000, 50_000, 20, 26, seed=402)),
    _e("band_40k_d24",  "band", lambda: sprand.banded(40_000, 40_000, 24, 30, seed=403)),
    _e("band_40k_d28",  "band", lambda: sprand.banded(40_000, 40_000, 28, 32, seed=404)),
    _e("band_30k_d32",  "band", lambda: sprand.banded(30_000, 30_000, 32, 36, seed=405)),
    _e("fem_30k_d40",   "fem",  lambda: sprand.banded(30_000, 30_000, 40, 30, seed=501)),
    _e("fem_30k_d48",   "fem",  lambda: sprand.banded(30_000, 30_000, 48, 32, seed=502)),
    _e("fem_24k_d56",   "fem",  lambda: sprand.banded(24_000, 24_000, 56, 34, seed=503)),
    _e("fem_24k_d64",   "fem",  lambda: sprand.banded(24_000, 24_000, 64, 36, seed=504)),
    _e("fem_20k_d72",   "fem",  lambda: sprand.banded(20_000, 20_000, 72, 38, seed=505)),
    _e("fem_12k_d120",  "fem",  lambda: sprand.banded(12_000, 12_000, 120, 48, seed=506)),
    _e("femblk_20k",    "fem",  lambda: sprand.block_diag_fem(20_000, 20_000, 64, 0.9, seed=507)),
    _e("femblk_24k",    "fem",  lambda: sprand.block_diag_fem(24_000, 24_000, 48, 0.85, seed=508)),
)

assert len(SUITE) == 25

_CACHE: dict[str, CSR] = {}


def get_matrix(name: str) -> CSR:
    """Build (and cache) a suite matrix by name."""
    if name not in _CACHE:
        entry = next(e for e in SUITE if e.name == name)
        _CACHE[name] = entry.build()
    return _CACHE[name]


def mini_suite(scale: int = 20) -> list[tuple[str, CSR]]:
    """A fast reduced suite (rows ~ full/scale) for unit tests."""
    out = []
    specs = [
        ("mini_er", sprand.erdos_renyi(120_000 // scale, 120_000 // scale, 3, seed=11)),
        ("mini_pl", sprand.power_law(100_000 // scale, 100_000 // scale, 5, 1.6, seed=12)),
        ("mini_rmat", sprand.rmat(80_000 // scale, 80_000 // scale, 640_000 // scale, seed=13)),
        ("mini_band", sprand.banded(40_000 // scale, 40_000 // scale, 24, 30, seed=14)),
        ("mini_fem", sprand.banded(20_000 // scale, 20_000 // scale, 60, 34, seed=15)),
    ]
    out.extend(specs)
    return out


def iter_cases(names: list[str] | None = None) -> Iterator[tuple[str, str, CSR, CSR]]:
    """All (A, B) pairs with the paper's reshape rule applied — 625 by default."""
    sel = names or [e.name for e in SUITE]
    for na in sel:
        a = get_matrix(na)
        for nb in sel:
            b = get_matrix(nb)
            am, bm = match_dims(a, b)
            yield na, nb, am, bm
