"""Logical-axis → mesh-axis rules (DESIGN §7), on a PyTorch device mesh.

Single-pod mesh: (data=16, model=16).  Multi-pod: (pod=2, data=16, model=16)
— `pod` extends data parallelism; with FSDP the weights/optimizer shard over
("data","pod") as well (ZeRO-3).

Per-config adjustments:
  * kv_heads shard over `model` only when divisible (else replicated — their
    activations are small; the decode cache shards over the sequence axis
    instead, see attention.py).
  * FSDP configs shard the `embed` (d_model) dimension of weights over
    `data`(+`pod`), gathered at use — ZeRO-3.

A layout is a ``PartitionSpec``: per tensor dimension ``None``
(replicated), one mesh-axis name, or a tuple of names (sharded over their
product, the first the major one), normalised as JAX normalises its
``PartitionSpec``.  ``placements`` turns one into DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions.

``constrain_batch`` / ``constrain_spec`` pin an activation's layout where
the JAX package calls ``with_sharding_constraint``: inside ``use_mesh(mesh)``
a DTensor is redistributed to the spec; outside a mesh they return their
argument itself.  JAX's two A/B switches for these pins
(``REPRO_NO_ACT_CONSTRAINT``, ``REPRO_NO_MOE_CONSTRAINT``) are left out.
"""
from __future__ import annotations

import contextlib
import contextvars

from .schema import logical_axes, tree_map

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


class PartitionSpec(tuple):
    """A tensor's layout: one entry a dimension, each ``None``, a mesh-axis
    name or a tuple of names (a one-name tuple becomes the name, an empty
    one ``None``)."""

    def __new__(cls, *axes):
        def norm(ax):
            if isinstance(ax, (tuple, list)):
                ax = tuple(ax)
                return None if not ax else ax[0] if len(ax) == 1 else ax
            return ax
        return super().__new__(cls, (norm(a) for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of ``constrain_*`` and ``local_map``
    (JAX's ``with mesh:``), in this thread."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def ambient_mesh():
    return _MESH.get()


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: mesh dimension ``i`` is
    ``Shard(d)`` where dimension ``d`` names it, else ``Replicate()``.  A
    tuple of names shards in mesh order, the first name the major one."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def distribute(tensor, spec: PartitionSpec, mesh):
    """``tensor`` (whole, on every rank) as a DTensor laid out by ``spec``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(tensor, mesh, placements(spec, mesh))


def distribute_tree(tree, specs, mesh):
    """Every leaf of ``tree`` (nested dicts and named tuples) distributed by
    the spec at the same place in ``specs``."""
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, tuple) and not is_spec(specs):
        return type(tree)(*(distribute_tree(t, s, mesh)
                            for t, s in zip(tree, specs)))
    return distribute(tree, specs, mesh)


def redistribute(x, spec: PartitionSpec, mesh):
    """DTensor ``x`` laid out by ``spec`` on ``mesh`` (itself where it is
    already)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError("a tensor laid out on a mesh must be a "
                        f"DTensor, not {type(x).__name__}")
    want = placements(spec, mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def axes_of(x, dim: int):
    """The spec entry of ``x``'s layout on ``dim``: the mesh axes that shard
    it (``None`` for a replicated dim or a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return None
    dim %= x.ndim
    names = x.device_mesh.mesh_dim_names
    return P(tuple(n for n, p in zip(names, x.placements)
                   if isinstance(p, Shard) and p.dim == dim))[0]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def tp_specs(weights: dict) -> dict:
    """A block's weights as its ``local_map`` takes them: each leaf's
    `model`-sharded dimensions (its heads, experts or hidden units) kept,
    the rest (an FSDP-sharded ``embed``) gathered."""
    return {k: tp_specs(v) if isinstance(v, dict) else
            P(*["model" if axes_of(v, d) == "model" else None
                for d in range(v.ndim)]) for k, v in weights.items()}


def roll_rows(x, shift: int):
    """``torch.roll(x, shift, dims=1)`` of (batch, sequence, ...) ``x``:
    inside a mesh on each rank's rows (DTensor has no rule for ``roll`` in
    every PyTorch version)."""
    import torch
    return local_map(lambda t: torch.roll(t, shift, dims=1), (x,),
                     (rows(x),), rows(x))


def rows(x) -> PartitionSpec:
    """``x``'s layout with its batch (leading) dim as it is and the rest
    replicated."""
    return P(axes_of(x, 0), *[None] * (x.ndim - 1))


def replicated_like(t, ref):
    """Plain tensor ``t`` (the same on every rank) as a replicated DTensor
    on ``ref``'s mesh where ``ref`` is a DTensor; ``t`` itself otherwise."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicated(ndim: int) -> PartitionSpec:
    return P(*[None] * ndim)


def mesh_offset(x, dim: int) -> int:
    """Where this rank's shard of DTensor ``x`` starts along ``dim`` (its
    mesh coordinate times the shard's length; ``dim`` sharded over at most
    one mesh axis, evenly)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    dim %= x.ndim
    axes = [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]
    if not axes:
        return 0
    if len(axes) > 1 or x.shape[dim] % mesh.size(axes[0]):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not sharded "
                         f"evenly over one mesh axis: {x.placements}")
    return mesh.get_coordinate()[axes[0]] * (x.shape[dim]
                                             // mesh.size(axes[0]))


def local_map(fn, args, in_specs, out_specs, *, partial=None):
    """``fn(*args)`` outside a mesh.  Inside one, ``fn`` runs on each rank's
    shards: tensor ``args[i]`` is redistributed to ``in_specs[i]`` (a
    spec, or ``None`` to pass a plain value or tensor through as it is; a
    dict of tensors takes one spec a leaf, or ``"replicated"``) and each
    output becomes a DTensor laid out by its ``out_specs`` entry, summed
    over the mesh axes ``partial`` (a spec entry) where ranks hold parts of
    a sum.  Every block that holds weights runs so (tensor parallelism by
    hand, as Megatron writes it): DTensor's own propagation picks layouts
    (a sequence axis sharded) that it then has no rule for."""
    mesh = ambient_mesh()
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial

    def lay_out(a, spec):
        if spec is None:
            return a
        if isinstance(a, dict):
            return {k: lay_out(a[k], spec if spec == "replicated"
                               else spec[k]) for k in a}
        if spec == "replicated":
            spec = replicated(a.ndim)
        return redistribute(a, spec, mesh)

    laid = [lay_out(a, s) for a, s in zip(args, in_specs)]
    # the mesh axes ``fn``'s work is split over: a rank's gradient of an
    # input replicated along one of them is its part of a sum (Megatron's
    # all-reduce in the backward), along the others the whole gradient
    split = {i for t in _leaves(laid) if isinstance(t, DTensor)
             for i, p in enumerate(t.placements) if p.is_shard()}

    def local_of(a):
        if isinstance(a, dict):
            return {k: local_of(v) for k, v in a.items()}
        if not isinstance(a, DTensor):
            return a
        grad = [Partial() if i in split and p.is_replicate() else p
                for i, p in enumerate(a.placements)]
        return a.to_local(grad_placements=grad)

    local = [local_of(a) for a in laid]
    token = _MESH.set(None)        # ``fn`` sees plain tensors only
    try:
        out = fn(*local)
    finally:
        _MESH.reset(token)
    single = not isinstance(out, tuple)
    names = tuple(mesh.mesh_dim_names)

    summed = () if partial is None else \
        partial if isinstance(partial, tuple) else (partial,)

    def wrap(t, spec):
        pl = placements(spec, mesh)
        for ax in summed:
            pl[names.index(ax)] = Partial()
        return DTensor.from_local(t, mesh, pl, run_check=False)

    wrapped = [wrap(t, s) for t, s in zip((out,) if single else out,
                                          (out_specs,) if single
                                          else out_specs)]
    return wrapped[0] if single else tuple(wrapped)


def replicate(x):
    """A DTensor made whole on every rank (partial sums added up); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def reduce_partial(x):
    """DTensor ``x`` with its partial sums added up, its shards kept (a
    plain tensor as it is)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh,
                                                            pl)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def laid_out_like(x, ref):
    """DTensor ``x`` in DTensor ``ref``'s layout (``x`` itself where either
    is a plain tensor)."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(x, DTensor) and isinstance(ref, DTensor)) \
            or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def write_shard(dst, src) -> None:
    """Write DTensor ``src`` into DTensor ``dst``'s own shard in place (the
    whole of ``src`` taken to ``dst``'s layout)."""
    dst.to_local().copy_(
        src.redistribute(dst.device_mesh, dst.placements).to_local())


def constrain_batch(x, *, sharded_tail: dict[int, str] | None = None,
                    batch_over_model: bool = False):
    """Pin activation sharding: batch over data(+pod), rest replicated.

    Without this, the weights' FSDP sharding can reach the saved activation
    stacks (batch replicated, d_model sharded over `data` instead).  No-op
    outside a mesh.

    ``sharded_tail``: optional {dim: axis} for extra dims (e.g. vocab logits
    {2: "model"}).
    """
    m = ambient_mesh()
    if m is None:
        return x
    names = m.mesh_dim_names
    batch_names = (("pod", "data", "model") if batch_over_model
                   else ("pod", "data"))
    data_axes = tuple(a for a in batch_names if a in names)
    if not data_axes:
        return x
    spec = [None] * x.ndim
    spec[0] = data_axes
    for d, ax in (sharded_tail or {}).items():
        if ax in names:
            spec[d] = ax
    return redistribute(x, P(*spec), m)


def constrain_spec(x, spec: PartitionSpec):
    """``x`` redistributed to ``spec`` on the ambient mesh, axes the mesh
    lacks dropped (no-op outside a mesh)."""
    m = ambient_mesh()
    if m is None:
        return x
    names = set(m.mesh_dim_names)

    def keep(ax):
        if ax is None:
            return None
        if isinstance(ax, tuple):
            return tuple(a for a in ax if a in names)
        return ax if ax in names else None

    return redistribute(x, P(*[keep(a) for a in spec]), m)


def make_rules(cfg, *, mesh_model: int, multi_pod: bool,
               fsdp: bool | None = None):
    fsdp = cfg.fsdp if fsdp is None else fsdp
    data_axes = ("pod", "data") if multi_pod else ("data",)
    if not getattr(cfg, "tensor_parallel", True):
        # sub-1B archs: replicate weights, DP over (data × model)
        return {None: None, "layers": None, "vocab": None, "heads": None,
                "ff": None, "moe_ff": None, "expert": None, "ssm_inner": None,
                "embed": data_axes if fsdp else None, "kv_heads": None}
    return {
        None: None,
        "layers": None,
        "vocab": "model",
        "heads": "model",
        "ff": "model",
        "moe_ff": None,            # expert dim already uses `model` (EP)
        "expert": "model",
        "ssm_inner": "model",
        "embed": data_axes if fsdp else None,   # ZeRO-3 weight shard
        "kv_heads": "model" if cfg.num_kv_heads % mesh_model == 0 else None,
    }


def specs_from_schema(schema, rules) -> dict:
    """PSpec tree → PartitionSpec tree."""
    return tree_map(lambda ax: P(*[rules.get(a, None) for a in ax]),
                    logical_axes(schema))


def batch_specs(cfg, shape_kind: str, multi_pod: bool) -> dict:
    """Input shardings for a (tokens, ...) batch."""
    data = ("pod", "data") if multi_pod else "data"
    specs = {"tokens": P(data, None), "positions": P(None, data, None)
             if cfg.mrope_sections else P(data, None)}
    if cfg.frontend == "vision_stub":
        specs["patch_embeds"] = P(data, None, None)
    if cfg.frontend == "audio_stub":
        specs["frame_embeds"] = P(data, None, None)
    if shape_kind == "train":
        specs["labels"] = P(data, None)
    return specs


def cache_spec_tree(cfg, mesh_model: int, multi_pod: bool) -> dict:
    """Decode-cache shardings mirroring ``transformer.init_cache``:
    batch over data(+pod); the attention cache SEQUENCE axis over `model`
    (flash-decode, no head-divisibility constraint); SSM states over heads /
    channels where divisible, replicated otherwise (they are small).
    """
    from . import attention as attn_mod
    from . import ssm as ssm_mod
    from . import transformer as tmod

    data = ("pod", "data") if multi_pod else "data"

    def div(sz):  # shard over model only when the dim divides evenly
        return "model" if sz % mesh_model == 0 else None

    def kind_spec(kind):
        if kind in ("attn", "moe"):
            if cfg.attention_type == "mla":
                return attn_mod.KVCache(P(None, data, "model", None),
                                        P(None, data, "model", None))
            return attn_mod.KVCache(P(None, data, None, "model", None),
                                    P(None, data, None, "model", None))
        if kind == "mamba":
            di, h, p_, n = ssm_mod.mamba_dims(cfg)
            return ssm_mod.MambaCache(P(None, data, div(h), None, None),
                                      P(None, data, None, div(di + 2 * n)))
        if kind == "mlstm":
            di, h, dk = ssm_mod.mlstm_dims(cfg)
            return ssm_mod.MLSTMCache(P(None, data, div(h), None, None),
                                      P(None, data, None, div(di)))
        if kind == "slstm":
            h, dh = ssm_mod.slstm_dims(cfg)
            s = P(None, data, div(h), None)
            return ssm_mod.SLSTMCache(s, s, s, s)
        raise ValueError(kind)

    tree: dict = {}
    for si, seg in enumerate(tmod.segment_plan(cfg)):
        tree[f"seg{si}"] = {f"pos{j}": kind_spec(k)
                            for j, k in enumerate(seg.kinds)}
    if cfg.attn_every:
        tree["shared_attn"] = attn_mod.KVCache(
            P(None, data, None, "model", None),
            P(None, data, None, "model", None))
    return tree
