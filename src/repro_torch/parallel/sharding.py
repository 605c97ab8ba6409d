"""Logical-axis sharding: one rule table maps model axes onto mesh axes.

Twin of ``repro/parallel/sharding.py``. Model code never names mesh axes;
it annotates activations and parameters with *logical* axes ("batch",
"heads", "mlp", "experts", ...) and the active rule set resolves them
onto the ("pod", "data", "model") mesh. A logical rule is dropped for a
tensor dimension whose size the mesh axes do not divide (8 KV heads on a
16-way model axis: the GQA replication fallback), so one rule table
serves all 10 architectures.

The reference resolves to a ``PartitionSpec``; here :meth:`ShardingCtx.spec`
returns the same per-dimension tuple (``None``, one axis name, or a tuple
of names, major first) and :func:`placements` turns it into ``DTensor``
placements, one ``Shard(d)`` or ``Replicate()`` per mesh dimension. The
mesh is a ``torch.distributed.device_mesh.DeviceMesh``; resolving specs
needs only its axis names and sizes, so a mapping ``{name: size}`` (or
anything with a ``shape`` mapping, as a JAX mesh has) serves too.
``torch.distributed.tensor`` is imported only where a placement or a
``DTensor`` is made.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import sys
from typing import Mapping, Sequence

import torch

# logical axis -> mesh axes (a tuple means "shard over both, in order")
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch":        ("pod", "data"),   # data parallel
    "seq":          None,              # sequence kept whole by default
    "seq_shard":    "data",            # SP: long-context activations
    "embed":        None,
    "q_features":   "model",           # heads × head_dim, flattened
    "kv_features":  "model",
    "heads":        "model",
    "kv_heads":     "model",
    "head_dim":     None,
    "mlp":          "model",           # TP: FFN hidden
    "vocab":        "model",           # TP: embedding/logits
    "experts":      "model",           # EP
    "capacity":     None,
    "kv_lora":      None,
    "inner":        "model",           # SSM d_inner
    "state":        None,
    "conv":         None,
    "layers":       None,
    "fsdp":         "data",            # parameter sharding (ZeRO-3 style)
    "ssm_heads":    "model",
    # decode caches (serve_step): batch over DP, heads/head_dim over TP;
    # long-context batch-1 cells override cache_seq -> ("data",)
    "cache_batch":  ("pod", "data"),
    "cache_seq":    None,
    "cache_kv_heads": "model",
    "cache_head_dim": "model",
    # paged KV pool (serve.paging): the page axis is replicated by default
    # so every shard can gather any slot's pages locally; override to
    # "data" to spread the pool over the data axis. Heads reuse
    # cache_kv_heads -> "model" with the same GQA non-divisible fallback
    # as dense caches.
    "cache_pages":  None,
}

#: one entry of a spec: replicated, one mesh axis, or several (major first)
SpecEntry = str | tuple[str, ...] | None


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a mapping, or anything
    with a ``shape`` mapping (a JAX mesh)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return {str(k): int(v) for k, v in shape.items()}
    raise TypeError(f"a mesh gives axis names and sizes: a DeviceMesh with "
                    f"mesh_dim_names or a mapping, not {type(mesh).__name__}")


def _names(entry: SpecEntry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class ShardingCtx:
    """The active rule set on a mesh. ``any_order`` lets a dimension shard
    over several mesh axes listed out of the mesh's order (the perf
    driver's ("model", "data") rules): its placements then lay the
    dimension out in the mesh's order, the same axes and shard sizes
    with another assignment of blocks to ranks, which is all a dry-run
    counts. Off, such a spec raises (see :func:`placements`)."""

    def __init__(self, mesh, rules: dict | None = None,
                 fsdp_params: bool = True, any_order: bool = False):
        self.mesh = mesh
        self.shape = axis_sizes(mesh)
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.fsdp_params = fsdp_params
        self.any_order = any_order

    def mesh_axes(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        r = self.rules.get(logical)
        if r is None:
            return ()
        axes = (r,) if isinstance(r, str) else tuple(r)
        # a rule may name axes the current mesh doesn't have (single-pod
        # meshes have no "pod"): drop them
        return tuple(a for a in axes if a in self.shape)

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def spec(self, logical_axes: Sequence[str | None],
             dims: Sequence[int] | None = None) -> tuple[SpecEntry, ...]:
        """Resolve logical axes to one entry per dimension, dropping
        indivisible or already-used mesh axes (of several axes, the
        longest prefix that divides stays)."""
        used: set[str] = set()
        parts: list[SpecEntry] = []
        for i, name in enumerate(logical_axes):
            axes = tuple(a for a in self.mesh_axes(name) if a not in used)
            if dims is not None:
                while axes and dims[i] % self.axis_size(axes) != 0:
                    axes = axes[:-1]
            used.update(axes)
            parts.append(None if not axes else
                         axes[0] if len(axes) == 1 else axes)
        return tuple(parts)

    def named(self, logical_axes: Sequence[str | None],
              dims: Sequence[int] | None = None) -> "NamedSharding":
        return NamedSharding(self.mesh, self.spec(logical_axes, dims),
                             self.any_order)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec: what ``jax.sharding.NamedSharding``
    holds. :attr:`placements` gives the ``DTensor`` placements."""

    mesh: object
    spec: tuple[SpecEntry, ...]
    any_order: bool = False

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec, any_order=self.any_order)


def placements(mesh, spec: Sequence[SpecEntry], *,
               any_order: bool = False) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: for each mesh
    dimension in order, ``Shard(d)`` where dimension ``d``'s entry names
    it, else ``Replicate()``. Several axes on one dimension shard it with
    the earlier mesh dimension major, as a JAX spec's tuple does, so such
    a tuple must list its axes in the mesh's order, unless ``any_order``
    (see :class:`ShardingCtx`)."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(axis_sizes(mesh))
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        names = _names(entry)
        if not any_order and [order.index(a) for a in names] != sorted(
                order.index(a) for a in names):
            raise ValueError(f"dimension {d} shards over {names}, not in "
                             f"the mesh's order {tuple(order)}")
        where.update((a, d) for a in names)
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in order)


_CTX: contextvars.ContextVar[ShardingCtx | None] = contextvars.ContextVar(
    "sharding_ctx", default=None)


def current() -> ShardingCtx | None:
    return _CTX.get()


@contextlib.contextmanager
def use(ctx: ShardingCtx | None):
    """Make ``ctx`` the active rule set. Under a ctx, plain tensors made
    inside the layers (rotary tables, masks, zero accumulators) meet
    ``DTensor`` activations as replicated ones (``implicit_replication``),
    as the reference's jit treats its constants; with no ctx nothing else
    is entered."""
    token = _CTX.set(ctx)
    try:
        if ctx is None:
            yield ctx
        else:
            from repro_torch.parallel.dtensor_tools import \
                implicit_replication
            with implicit_replication():
                yield ctx
    finally:
        _CTX.reset(token)


def is_dtensor(x) -> bool:
    """``isinstance(x, DTensor)``, without importing
    ``torch.distributed.tensor`` where nothing has made one."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names.

    Outside a ctx it returns ``x`` itself (one ``ContextVar`` lookup).
    Under a ctx a ``DTensor`` is redistributed to the resolved placements;
    a plain tensor is returned as it is: its values and local shape never
    change."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} axes for rank-{x.ndim} tensor")
    if not is_dtensor(x):
        return x
    want = placements(ctx.mesh, ctx.spec(logical_axes, x.shape),
                      any_order=ctx.any_order)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(ctx.mesh, want)


def replicated(x) -> bool:
    """A plain tensor, or a ``DTensor`` every rank holds whole."""
    return not is_dtensor(x) or all(p.is_replicate() for p in x.placements)


def local_chunk(full: torch.Tensor, mesh, place: Sequence) -> torch.Tensor:
    """This rank's part of ``full`` (the same on every rank) under the
    placements ``place``: a local slice, no communication."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(full, mesh, [Replicate()] * len(place),
                              run_check=False).redistribute(
        mesh, place).to_local()


def gather(local: torch.Tensor, mesh, place: Sequence) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's part under the
    placements ``place``, on every rank (a collective: every rank of
    ``mesh`` calls it). Where no placement splits the tensor (replicated,
    or sharded over mesh dimensions of size 1, as on a 1-device mesh)
    ``local`` already is the whole, and no collective runs."""
    if all(p.is_replicate() or mesh.size(i) == 1
           for i, p in enumerate(place)):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, place,
                              run_check=False).full_tensor()


def update_whole(x: torch.Tensor, write) -> None:
    """Apply ``write`` (an in-place edit of a plain tensor) to the whole
    of the ``DTensor`` ``x`` and keep this rank's part, for layouts whose
    local part cannot take the edit alone. Every rank of ``x``'s mesh
    calls it."""
    full = x.full_tensor()
    write(full)
    x.to_local().copy_(local_chunk(full, x.device_mesh, x.placements))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``full`` (the same on every rank) as a ``DTensor`` laid out by
    ``sharding``, each rank keeping only its part: the twin of
    ``jax.device_put(x, NamedSharding(...))``. On a CUDA mesh the tensor
    moves to this rank's card."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    full = full.to(mesh_device(mesh))
    place = sharding.placements
    return DTensor.from_local(local_chunk(full, mesh, place).clone(), mesh,
                              place, run_check=False)


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gathered whole on every rank (a collective: every
    rank of its mesh calls it, and autograd passes through it); a plain
    tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def to_local(x: torch.Tensor, grad_placements=None) -> torch.Tensor:
    """This rank's local tensor of the ``DTensor`` ``x``, for work done
    shard by shard. ``grad_placements`` says how the local gradient lies
    over the mesh where it is not laid out as ``x`` (``Partial`` where
    each rank's gradient is its share of a sum). The gradient reaches
    ``x`` contiguous: a local gradient laid out otherwise (a product's
    transposed result) would fail the views ``DTensor`` runs on it."""
    return _ContiguousGrad.apply(x.to_local(grad_placements=grad_placements))


def shard_index(mesh, dims: Sequence[int]) -> int:
    """This rank's index among the shards that the mesh dimensions
    ``dims`` (in the mesh's order) cut a tensor dimension into, the first
    major, as ``DTensor`` lays several ``Shard``s of one dimension out."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def contiguous_strides(shape: Sequence[int]) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``, made without a
    tensor (a dry-run counts every tensor made while a step runs)."""
    strides, n = [], 1
    for d in reversed(tuple(shape)):
        strides.append(n)
        n *= max(1, d)
    return tuple(reversed(strides))


def on_mesh_of(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x``, a plain tensor every rank holds whole, as a replicated
    ``DTensor`` on ``like``'s mesh where ``like`` is a ``DTensor`` (no
    communication; autograd passes through); else ``x`` itself."""
    if not is_dtensor(like):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def view_heads(x: torch.Tensor, shape: Sequence[int],
               logical: str) -> torch.Tensor:
    """``x.reshape(shape)``, a view that splits ``x``'s dimension 2 into
    ``shape[2]`` heads (by the ``logical`` heads axis) and what follows:
    (B, S, heads·head_dim) into (B, S, heads, head_dim), or GQA's (B, S,
    H, D) into (B, S, Hkv, group, D). Under a ctx a ``DTensor`` is first
    laid out with its dimension 2 sharded as ``logical`` resolves for
    ``shape[2]`` heads, so that the view splits whole heads: where the
    heads do not divide the mesh axis (8 KV heads on a 16-way "model"
    axis) it falls back to replicated, as the reference's rules resolve
    ``kv_heads``. A plain tensor, or no ctx, is a plain reshape."""
    ctx = _CTX.get()
    if ctx is not None and is_dtensor(x):
        spec = ctx.spec(("batch", "seq", logical), tuple(shape[:3]))
        want = placements(ctx.mesh, spec, any_order=ctx.any_order)
        if tuple(x.placements) != want:
            x = x.redistribute(ctx.mesh, want)
    return x.reshape(*shape)


# -- parameter logical axes --------------------------------------------------
# Parameters carry logical axes by name (``models.layers.PARAM_AXES``);
# ``param_shardings`` resolves them, optionally adding FSDP sharding of the
# largest divisible unsharded dimension.


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def param_shardings(logical, shapes, ctx: ShardingCtx):
    """The :class:`NamedSharding` of one parameter (``logical`` a tuple of
    logical axes, ``shapes`` its tensor or shape), or a dict of them,
    keyed as ``logical`` is (``param_logical_axes``)."""
    if not _is_axes(logical):
        return {k: param_shardings(a, shapes[k], ctx)
                for k, a in logical.items()}
    shape = tuple(getattr(shapes, "shape", shapes))
    spec = list(ctx.spec(logical, shape))
    spec += [None] * (len(shape) - len(spec))
    if ctx.fsdp_params:
        used = {a for s in spec for a in _names(s)}
        fsdp_axes = tuple(a for a in ctx.mesh_axes("fsdp") if a not in used)
        if fsdp_axes:
            size = ctx.axis_size(fsdp_axes)
            # shard the largest free dimension divisible by the fsdp axes
            cand = sorted((i for i, s in enumerate(spec)
                           if s is None and shape[i] % size == 0),
                          key=lambda i: -shape[i])
            if cand:
                spec[cand[0]] = (fsdp_axes if len(fsdp_axes) > 1
                                 else fsdp_axes[0])
    return NamedSharding(ctx.mesh, tuple(spec), ctx.any_order)
