"""Traffic loops, one module a loop, found by the name that a traffic mix
gives under ``"loop"``.

A traffic mix (``traffic/<mix>.json``) is the parameters of one loop.  A
new mix of a loop that exists is one data file; a new kind of traffic is a
module here and a data file, and edits no file that exists.  Each module
has:

- ``KEYS``: ``{parameter: type}``, the mix keys the loop reads.  A mix with
  a key that neither the loop nor the driver reads, without one of them, or
  with a value of another type, is refused before set-up.
- ``PLANS``: whether the window's calls plan (then the check holds each
  plan's prediction to eq. 4).
- ``inputs(cell, i) -> (member, labels_index)``: the structure member and
  the labels of call ``i``; its values are ``cell.values(.., "values", i)``.
- ``Loop(cell)``: set-up (the cell's own shapes, warm calls), timed as
  set-up steps through ``cell.step``; ``prepare(i, rec)``, the inputs of
  call ``i`` (in the window, outside the call's latency);
  ``call(i, rec) -> (plan, out, overflow)``, the call itself, from its first
  call into the program to the read of its overflow count; ``release()``,
  which drops the program's state.
"""
from __future__ import annotations

import importlib

# the driver's own keys of a mix
DRIVER_KEYS = {"name": str, "described_as": str, "loop": str,
               "check_first": int}


def find(name: str):
    """The loop module ``chipbench.loops.<name>``."""
    return importlib.import_module(f"chipbench.loops.{name}")


def load(mix: dict):
    """The loop that ``mix`` names, once its keys and types are checked."""
    want = {**DRIVER_KEYS, **find(mix["loop"]).KEYS}
    extra, missing = set(mix) - set(want), set(want) - set(mix)
    if extra or missing:
        raise ValueError(f"traffic {mix.get('name')!r}: keys {sorted(extra)}"
                         f" are not read, {sorted(missing)} are missing")
    for k, t in want.items():
        if type(mix[k]) is not t:
            raise ValueError(f"traffic {mix['name']!r}: {k} is "
                             f"{mix[k]!r}, not {t.__name__}")
    return find(mix["loop"])
