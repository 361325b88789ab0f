"""Input generators, one module a generator, found by the name that a
configuration file gives under ``"generator"``.  Each has ``KEYS``, the
configuration keys it reads, and
``make(cfg, seed, device, member=0, labels_index=None) -> Pattern``: the
sparsity pattern of ``member`` (one of the configuration's fixed
structures) under the labels drawn from ``seed`` and ``labels_index``."""
from __future__ import annotations

import importlib
from typing import NamedTuple

import torch


class Pattern(NamedTuple):
    rpt: torch.Tensor            # (M + 1,) int64, on the device
    col: torch.Tensor            # (nnz,) int32, ascending within a row
    perm: torch.Tensor | None    # label permutation (None: the identity)


def find(name: str):
    """The generator module ``chipbench.generators.<name>``."""
    return importlib.import_module(f"chipbench.generators.{name}")
