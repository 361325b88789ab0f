"""Graph500's Kronecker graph as a symmetric sparse matrix, made on a device.

The edge list follows the Graph500 specification's reference generator
(``kronecker_generator.m``): ``edgefactor · 2^scale`` edges, each placed
bit by bit in the quadrants of an initiator ``[[A, B], [C, D]]``, then the
vertex labels permuted at random.  The matrix is that graph as the
benchmark multiplies it: self-loops dropped, every edge stored both ways,
repeated edges merged, columns ascending within a row.

The edges and the labels come from separate streams.  The edges of
``member`` ``k`` come from the configuration's ``structure_seed`` and
``k``; the labels from the run's seed (and a call index).  So every seed
multiplies graphs isomorphic to one fixed set, the same work in another
order (the specification permutes the labels for the same reason).
"""
from __future__ import annotations

import torch

from chipbench import seeds
from chipbench.generators import Pattern

KEYS = ("scale", "edgefactor", "initiator")


def edges(scale: int, edgefactor: int, initiator, edge_seed: int,
          device) -> tuple[torch.Tensor, torch.Tensor]:
    """The unpermuted edge list ``(i, j)`` (int64) of the reference
    generator."""
    a, b, c, _ = (float(x) for x in initiator)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    m = int(edgefactor) << int(scale)
    g = seeds.generator(device, edge_seed)
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for ib in range(int(scale)):
        ii = torch.rand(m, generator=g, device=device) > ab
        jj = torch.rand(m, generator=g, device=device) > torch.where(
            ii, c_norm, a_norm)
        i += ii.to(torch.int64) << ib
        j += jj.to(torch.int64) << ib
    return i, j


def symmetric_pattern(i: torch.Tensor, j: torch.Tensor, n: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rpt, col)`` of the graph's symmetric pattern: self-loops dropped,
    both directions stored, repeats merged, columns ascending in a row."""
    keep = i != j
    i, j = i[keep], j[keep]
    keys = torch.unique(torch.cat([i * n + j, j * n + i]))
    rpt = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    rpt[1:] = torch.cumsum(torch.bincount(keys // n, minlength=n), 0)
    return rpt, (keys % n).to(torch.int32)


def labels(n: int, label_seed: int, device) -> torch.Tensor:
    """The label permutation (vertex ``v`` becomes ``perm[v]``)."""
    return torch.randperm(n, generator=seeds.generator(device, label_seed),
                          device=device)


def make(cfg: dict, seed: int, device, member: int = 0,
         labels_index: int | None = None) -> Pattern:
    """``member``'s graph under the labels of run ``seed`` (and call
    ``labels_index``) on ``device``."""
    n = 1 << int(cfg["scale"])
    i, j = edges(cfg["scale"], cfg["edgefactor"], cfg["initiator"],
                 seeds.derive(int(cfg["structure_seed"]), "edges", member),
                 device)
    perm = labels(n, seeds.derive(seed, "labels", labels_index), device)
    return Pattern(*symmetric_pattern(perm[i], perm[j], n), perm)

