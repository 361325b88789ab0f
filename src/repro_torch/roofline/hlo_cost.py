"""Per-chip FLOPs, bytes and collective bytes of a PyTorch step.

The JAX package derives these from the partitioned HLO text of a compiled
step.  PyTorch has no HLO: this module runs the step once under a dispatch
mode (``CostCounter``) and counts the ATen ops it dispatches, on each
rank's own shards:

  * FLOPs — ``torch.utils.flop_counter``'s formulas (matrix products,
    attention, convolutions; elementwise work is not counted, as the JAX
    model does not count it either) applied to each op's local operands.
    A DTensor op is left to DTensor, which runs it as local ops on the
    shards; those are what is counted, so a chip's share of the work,
    replicated work included, is what comes out (``FlopCounterMode``
    entered around DTensor code counts the global op instead).
  * bytes — every op's input and output bytes (each distinct element a
    tensor refers to once): what unfused eager PyTorch moves through HBM.
    It is not the JAX package's post-fusion count, which leaves out what a
    fusion keeps on chip, so it reads higher; views move nothing.
  * collectives — the output bytes of each functional collective DTensor
    issues, under JAX's five kinds.
  * peak bytes — the most bytes the run's own outputs held at once (the
    resident tensors handed to ``track`` added), what ``compiled.
    memory_analysis()`` gives the JAX package.  PyTorch's ``MemTracker``
    is not used: under the dry run's single fake mode it also holds the
    global-shaped outputs of DTensor's sharding propagation.

A Python loop over layers runs its body once a pass and each pass is
counted, so JAX's while-loop trip counts have no counterpart here.  Ops
that DTensor runs only to learn an output's shape (its sharding
propagation) are not counted.

  analyze(fn, *args, **kwargs) → {"flops", "bytes", "collectives",
                                   "collective_bytes"}
"""
from __future__ import annotations

import math
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# functional collectives (``torch.ops._c10d_functional``) by JAX's kind
_KIND = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
         ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
         ("permute", "collective-permute"))
_NO_BYTES = {"empty", "empty_strided", "empty_like", "detach",
             "lift_fresh", "alias", "_local_scalar_dense"}


def _tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` refers to (a broadcast
    dimension once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _in_sharding_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if "sharding_prop" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


class CostCounter(TorchDispatchMode):
    """Counts the local ATen ops dispatched while it is active (see the
    module docstring).  ``track`` adds tensors that live through the run
    (parameters, optimizer state, inputs) to its memory account."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        self._formulas = flop_registry
        self._live = WeakIdKeyDictionary()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0.0 for k in _COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": dict(self.collectives),
                "collective_bytes": float(sum(self.collectives.values()))}

    def track(self, *trees) -> None:
        for t in tree_flatten(trees)[0]:
            if isinstance(t, torch.Tensor):
                self._hold(getattr(t, "_local_tensor", t))

    def _hold(self, t: torch.Tensor) -> None:
        import weakref
        st = t.untyped_storage()
        if st in self._live:
            return
        n = st.nbytes()
        self._live[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it as local ops
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name == "wait_tensor" or _in_sharding_propagation():
            return out
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += float(self._formulas[packet](*args, **kwargs,
                                                       out_val=out))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if func.namespace.startswith("_c10d_functional"):
            kind = next((k for key, k in _KIND if key in name), name)
            self.collectives[kind] = self.collectives.get(kind, 0.0) + sum(
                _tensor_bytes(t) for t in outs)
        if not func.is_view and name not in _NO_BYTES:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_tensor_bytes(t) for t in ins + outs)
        for t in outs:
            self._hold(t)
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its ops (module
    docstring): {"flops", "bytes", "collectives", "collective_bytes"}."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.result()
