"""Per-layer metrics, one module a metric, found by the metric's name in
``BENCHMARK.json``.  Each has ``read(ctx) -> float | None``; ``ctx`` is a
:class:`chipbench.driver.Context`.  A reader that finds nothing to read
returns None, and the metric is left out of the result."""
from __future__ import annotations

import importlib


def find(name: str):
    """The reader module ``chipbench.layer_metrics.<name>``."""
    return importlib.import_module(f"chipbench.layer_metrics.{name}")
