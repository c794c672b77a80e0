"""MeshContext: the explicit sharding context threaded through the
program, counterpart of ``repro.sharding.context``.

As in the reference, a :class:`MeshContext` bundles

* ``mesh``        -- a ``torch.distributed`` ``DeviceMesh`` with named
                    axes (``launch/mesh.py``), or ``None`` off-mesh: the
                    single-process path, where every model call is
                    today's;
* ``rules``       -- the active :class:`~repro_torch.sharding.partition
                    .ShardingRules` plan (logical axis -> mesh axes);
* ``manual_axes`` -- mesh axes an enclosing per-shard body already holds;
                    :meth:`resolve` strips them;

and is passed down the layer stack as an ordinary argument, with a thin
contextvar (:func:`current_ctx`, ``with ctx:``) beside it.

Eager PyTorch has no partitioner, so what GSPMD derives from the
reference's constraints is written out here in PyTorch's idiom:

* :meth:`MeshContext.shard` cuts a full tree into this rank's slices by
  the plan's resolved specs, and :meth:`MeshContext.gather` rebuilds the
  full tree from them with an autograd-aware all-gather, whose backward
  pass reduce-scatters the gradient (FSDP's gather on use);
* :meth:`MeshContext.all_to_all`, :meth:`MeshContext.all_gather` and
  :meth:`MeshContext.all_reduce` are autograd-aware collectives over the
  process group of one or more mesh axes (the expert-parallel schedule of
  ``core/expert_parallel.py`` and its balance statistics);
* :meth:`MeshContext.reshard` relays a materialized tree onto this
  context's plan (each rank keeps the slice its plan resolves: the
  serving prefill_tp -> decode_std handoff; ``serve/kv_cache.py``'s
  ``SlotKVCache.extract`` gathers a pool slot's page back to whole);
* :meth:`MeshContext.shift` moves a tensor one rank along an axis (the
  pipeline's stage ring; its backward pass is the reverse shift);
* :meth:`MeshContext.with_constraint` is the identity.

A body that holds axes itself (:meth:`MeshContext.manual`, the
pipeline's stage body) sees the mesh without them: its rank count,
coordinate and default collectives span the other axes only, and its
specs strip them, as the reference's manual axes do.

The row split (:meth:`MeshContext.split_rows`, the one rule the trainer,
the pipeline and :func:`local_draws` follow): a (micro)batch's rows
split over every free axis where they divide, as before.  Where they do
not, they split over the plan's ``batch`` axes (the reference's ``("pod",
"data")``; none inside a pipeline stage) and stay whole on each rank of
the others (``model``); a flat MoE layer then takes this rank's
contiguous share of the rows' flattened tokens (the reference's
``tokens`` axis, over every axis) and all-gathers its output over those
ranks when it exits.  A contiguous token share of row-major ``[R, S]``
tokens is exactly a row share where R divides, so the tokens' order
(:attr:`MeshContext.token_axes`) is one rule in both cases.

Dense tensor parallelism (:meth:`MeshContext.tp_axes`, one rule): where
a step's rows are whole over some free axes (:attr:`MeshContext
.whole_over`), each dense dim of :data:`DENSE_TP` (attention's query and
key / value heads, the dense FFN's d_ff, the vocabulary) runs
tensor-parallel over those of its plan axes (``model`` under
``dp_tp_ep`` and ``prefill_tp``) that lie there, where the dim divides
(``resolve``'s fallback), as the reference's GSPMD splits them.  The
layers take column slices in and row slices out, and sum their partial
outputs with :meth:`MeshContext.all_reduce` (whose backward pass sums
the ranks' cotangents); the loss takes the max over the ranks with
:meth:`MeshContext.all_max`.  One process, rows split over every axis,
the engine's contexts and the decode step (``row_axes`` None) keep every
dim whole.

A collective over the ranks of a mesh axis of size 1 is the identity and
is skipped (on a (data 1, model 2) mesh, FSDP over ``data`` costs
nothing).

The collectives are small ``torch.autograd.Function`` s over
``torch.distributed``'s ``all_to_all_single``, ``all_gather`` and
``all_reduce``: the backward of an all-gather is an ``all_to_all_single``
and a sum over the sources (as ``torch.distributed.nn.functional``'s is
on gloo), and of an all-reduce another all-reduce.  gloo takes CUDA
tensors for all three (it moves them through host memory itself), so
two ranks sharing one card run over gloo and nothing here stages a
tensor by hand; NCCL is the backend wherever each rank has a card of
its own.

:func:`record_collectives` counts, per op (``all_to_all``,
``all_gather``, ``all_reduce``, ``shift``), the calls and the bytes this
rank sends (ring-algorithm bytes: (g-1)/g of an all-to-all's buffer,
g-1 times an all-gather's input, 2(g-1)/g of an all-reduce's tensor,
the tensor a shift sends), backward passes included: the dry run's
collective schedule (``launch/dryrun.py``), in ``launch/analytic.py``'s
convention.

The reference's jax-version shims (abstract-mesh queries, ``make_mesh``
with axis types, ``use_mesh``, ``shard_map``, ``axis_size``) have no
counterpart: they probe JAX's API surface, which the port does not use.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.common.param import ParamDef, tree_map
from repro_torch.sharding import partition

Spec = partition.Spec

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh_context", default=None)

# The dense dims a step whose rows are whole over some axes runs
# tensor-parallel over them (:meth:`MeshContext.tp_axes`): attention's
# query and key / value heads, the dense FFN's d_ff, the vocabulary.
DENSE_TP = ("heads", "kv_heads", "mlp", "vocab")


def _strip(spec: Spec, manual: frozenset) -> Spec:
    """Drop manual mesh axes from a resolved spec."""
    if not manual:
        return spec
    return tuple(tuple(a for a in axes if a not in manual) for axes in spec)


# ---------------------------------------------------------------------------
# the collective recorder
# ---------------------------------------------------------------------------

# Open record_collectives() tables (a list, not a context variable: the
# autograd engine may run a backward pass on another thread).
_RECORDS: list = []


@contextlib.contextmanager
def record_collectives():
    """Within the block, each collective of this module adds one call
    and the bytes this rank sends to the yielded table, ``{op: {"calls",
    "bytes"}}``."""
    table: dict = {}
    _RECORDS.append(table)
    try:
        yield table
    finally:
        _RECORDS.remove(table)


def _record(op: str, t: torch.Tensor, group, share) -> None:
    """One call of ``op`` on ``t`` over ``group``; ``share(g)`` is the
    fraction of ``t``'s bytes a rank sends in a group of ``g``."""
    if not _RECORDS:
        return
    sent = t.numel() * t.element_size() * share(dist.get_world_size(group))
    for table in _RECORDS:
        row = table.setdefault(op, {"calls": 0, "bytes": 0})
        row["calls"] += 1
        row["bytes"] += sent


def _a2a_share(g):
    return (g - 1) / g


# ---------------------------------------------------------------------------
# autograd-aware collectives
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with equal splits of dim 0; its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        _record("all_to_all", x, group, _a2a_share)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    """All ranks' ``x`` concatenated along ``dim`` in group-rank order;
    the backward pass sends each rank its chunk of the gradient
    (``all_to_all_single``) and sums what it receives."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        _record("all_gather", x, group, lambda g: g - 1)
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        chunks = torch.stack(torch.chunk(grad, n, dim=ctx.dim)).contiguous()
        got = torch.empty_like(chunks)
        _record("all_to_all", chunks, ctx.group, _a2a_share)
        dist.all_to_all_single(got, chunks, group=ctx.group)
        return torch.sum(got, dim=0), None, None


class _AllReduce(torch.autograd.Function):
    """Sum over the group; the backward pass sums the cotangents of every
    rank's copy (so a loss that every rank adds counts once per rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        _record("all_reduce", out, group, lambda g: 2 * (g - 1) / g)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group), None


def _all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group of a tensor outside autograd."""
    out = x.clone(memory_format=torch.contiguous_format)
    _record("all_reduce", out, group, lambda g: 2 * (g - 1) / g)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank i's ``x`` to rank i + step of the group (ranks past either
    end send or receive nothing; a rank that receives nothing gets
    zeros): one ``all_to_all_single`` with a single non-empty split each
    way, which gloo takes with CUDA tensors (it has no CUDA send /
    recv) and NCCL with its own."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    flat = x.contiguous().reshape(-1)
    m = flat.numel()
    dst, src = i + step, i - step
    if not 0 <= dst < n:
        flat = flat[:0]
    send = [m if j == dst else 0 for j in range(n)]
    recv = [m if j == src else 0 for j in range(n)]
    out = torch.empty((sum(recv),), dtype=x.dtype, device=x.device)
    _record("shift", flat, group, lambda g: 1)
    dist.all_to_all_single(out, flat, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    if 0 <= src < n:
        return out.reshape(x.shape)
    return torch.zeros_like(x)


class _Shift(torch.autograd.Function):
    """The pipeline's stage shift (the reference's ``ppermute`` i -> i+1):
    its backward pass is the reverse shift."""

    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, grad):
        return _Shift.apply(grad, ctx.group, -ctx.step), None, None


# ---------------------------------------------------------------------------
# MeshContext
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshContext:
    """mesh + sharding plan + the axes an enclosing body holds."""

    mesh: object | None            # torch DeviceMesh, or None off-mesh
    rules: partition.ShardingRules
    manual_axes: frozenset = frozenset()
    # The free axes the rows are split over (None: every free axis);
    # :meth:`split_rows` sets it.
    row_axes: tuple[str, ...] | None = None

    # -- construction -----------------------------------------------------
    @classmethod
    def for_mesh(cls, mesh, plan="dp_tp_ep") -> "MeshContext":
        """Context for a concrete mesh; ``plan`` is a PLANS name or rules."""
        return cls(mesh=mesh, rules=_as_rules(plan))

    @classmethod
    def null(cls, plan="dp_tp_ep") -> "MeshContext":
        """Off-mesh context: every path is the single-process one."""
        return cls(mesh=None, rules=_as_rules(plan))

    def with_plan(self, plan) -> "MeshContext":
        return dataclasses.replace(self, rules=_as_rules(plan))

    def manual(self, *axes: str) -> "MeshContext":
        """Derived context for a body that holds ``axes`` itself."""
        return dataclasses.replace(
            self, manual_axes=self.manual_axes | frozenset(axes))

    # -- the mesh ---------------------------------------------------------
    @property
    def axis_names(self) -> tuple[str, ...]:
        return () if self.mesh is None else tuple(self.mesh.mesh_dim_names)

    @property
    def free_axes(self) -> tuple[str, ...]:
        """The mesh axes this context's body does not hold itself (every
        axis outside a :meth:`manual` body)."""
        return tuple(a for a in self.axis_names if a not in self.manual_axes)

    @property
    def sizes(self) -> dict[str, int]:
        return {} if self.mesh is None else partition.axis_sizes(self.mesh)

    def size(self, axes: Sequence[str] | None = None) -> int:
        """Ranks along ``axes`` (default: every free mesh axis)."""
        axes = self.free_axes if axes is None else axes
        return math.prod(self.sizes[a] for a in axes)

    @property
    def world(self) -> int:
        return self.size()

    def index(self, axes: Sequence[str] | None = None) -> int:
        """This rank's coordinate over ``axes``, row-major (default: every
        free mesh axis, which is the token and batch sharding's order)."""
        axes = self.free_axes if axes is None else axes
        idx = 0
        for a in axes:
            idx = idx * self.sizes[a] + self.mesh.get_local_rank(a)
        return idx

    @property
    def device(self) -> torch.device:
        """This rank's device: the mesh's device type (and the current
        CUDA device)."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    @property
    def is_writer(self) -> bool:
        """Whether this rank prints and writes files (rank 0, or off-mesh)."""
        return self.mesh is None or dist.get_rank() == 0

    def barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    # -- resolution -------------------------------------------------------
    def resolve(self, shape, logical_axes, fallbacks: list | None = None
                ) -> Spec:
        """Logical axes -> :data:`Spec` (manual axes stripped)."""
        if self.mesh is None:
            raise RuntimeError("resolve() needs a concrete mesh")
        spec = partition.resolve_spec(self.rules, self.mesh, shape,
                                      logical_axes, fallbacks)
        return _strip(spec, self.manual_axes)

    def specs(self, defs, fallbacks: list | None = None):
        """:data:`Spec` tree of a ParamDef tree."""
        return tree_map(lambda d: self.resolve(d.shape, d.axes, fallbacks),
                        defs)

    def replicated_axes(self, spec: Spec) -> tuple[str, ...]:
        """The mesh axes that shard no dimension of ``spec``."""
        used = {a for axes in spec for a in axes}
        return tuple(a for a in self.axis_names if a not in used)

    # -- constraints ------------------------------------------------------
    def with_constraint(self, x, logical_axes):
        """The identity: eager PyTorch has no partitioner to hand a
        layout to.  Where the reference's constraints make GSPMD move
        data, the port moves it explicitly (:meth:`shard`,
        :meth:`gather`, the collectives)."""
        return x

    # -- collectives ------------------------------------------------------
    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def _spread(self, axes: Sequence[str]) -> tuple[str, ...]:
        """The axes of ``axes`` with more than one rank (a collective
        over one rank is the identity, and is skipped)."""
        return tuple(a for a in axes if self.sizes[a] > 1)

    def _groups(self, axes: Sequence[str]) -> list:
        """Process groups that together span ``axes``: the default group
        when they are every mesh axis with more than one rank, else one
        group per axis."""
        axes = self._spread(axes)
        if axes and set(axes) == set(self._spread(self.axis_names)):
            return [dist.group.WORLD]
        return [self.group(a) for a in axes]

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Equal chunks of dim 0 to each rank along ``axis``, chunk j to
        the rank at coordinate j; the received chunks in source order."""
        if self.sizes[axis] == 1:
            return x
        return _AllToAll.apply(x, self.group(axis))

    def all_gather(self, x: torch.Tensor, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
        """Concatenate the shards of a dimension sharded over ``axes``
        (row-major, as :meth:`shard` cuts it) along ``dim``."""
        for a in reversed(self._spread(axes)):
            x = _AllGather.apply(x, self.group(a), dim)
        return x

    def axes_of(self, logical: str) -> tuple[str, ...]:
        """The free mesh axes the plan maps a logical axis to (before
        any divisibility fallback)."""
        return tuple(a for a in self.rules.lookup(logical)
                     if a in self.sizes and a not in self.manual_axes)

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str] | None = None
                   ) -> torch.Tensor:
        """Sum over the ranks along ``axes`` (default: every free axis)."""
        axes = self.free_axes if axes is None else tuple(axes)
        for g in self._groups(axes):
            x = _AllReduce.apply(x, g)
        return x

    def all_reduce_(self, t: torch.Tensor,
                    axes: Sequence[str] | None = None) -> torch.Tensor:
        """In-place sum of a tensor outside autograd (gradients, norms)."""
        axes = self.free_axes if axes is None else tuple(axes)
        for g in self._groups(axes):
            _record("all_reduce", t, g, lambda n: 2 * (n - 1) / n)
            dist.all_reduce(t, group=g)
        return t

    def shift(self, x: torch.Tensor, axis: str, step: int = 1
              ) -> torch.Tensor:
        """Rank i's ``x`` to the rank at coordinate i + ``step`` along
        ``axis`` (autograd-aware: the backward pass shifts the gradient
        back); the first ``step`` ranks receive zeros."""
        if self.sizes[axis] == 1:
            return torch.zeros_like(x)
        return _Shift.apply(x, self.group(axis), step)

    # -- trees ------------------------------------------------------------
    @property
    def rows_over(self) -> tuple[str, ...]:
        """The free mesh axes this context's rows are split over."""
        if self.row_axes is None:
            return self.free_axes
        return tuple(a for a in self.row_axes if a not in self.manual_axes)

    @property
    def whole_over(self) -> tuple[str, ...]:
        """The free mesh axes whose ranks each hold this context's rows
        whole (none where the rows split over every free axis)."""
        rows = self.rows_over
        return tuple(a for a in self.free_axes if a not in rows)

    def tp_axes(self, logical: str, size: int) -> tuple[str, ...]:
        """The mesh axes over which a dense dim (``logical``, one of
        :data:`DENSE_TP`, of ``size``) runs tensor-parallel: the axes the
        plan resolves it to (with ``resolve``'s divisibility fallback),
        where each holds this context's rows whole (:attr:`whole_over`)
        and has more than one rank; else none (off-mesh, rows split over
        every axis, the engine's contexts and the decode step, whose
        ``row_axes`` is None)."""
        if self.mesh is None or logical not in DENSE_TP:
            return ()
        whole = self.whole_over
        if not whole:
            return ()
        axes = self.resolve((size,), (logical,))[0]
        if not axes or any(a not in whole for a in axes):
            return ()
        return self._spread(axes)

    def all_max(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Elementwise max over the ranks along ``axes``, with no
        gradient (a softmax's shift)."""
        x = x.detach()
        for g in self._groups(axes):
            x = _all_max(x, g)
        return x

    @property
    def token_axes(self) -> tuple[str, ...]:
        """The order of the token sharding over every free axis: the
        rows' axes, then the axes that hold them whole."""
        return self.rows_over + self.whole_over

    def split_rows(self, rows: int, seq: int = 1) -> "MeshContext":
        """This context with the row split of a (micro)batch of ``rows``
        rows of ``seq`` tokens (the module docstring): every free axis
        where the rows divide over them; else the largest prefix of the
        plan's ``batch`` axes that divides them, the rows whole over the
        other axes, whose ranks then split each row's tokens.  Raises
        ValueError where those tokens do not divide either."""
        if rows % self.world == 0:
            return dataclasses.replace(self, row_axes=None)
        axes: list[str] = []
        n = 1
        for a in self.axes_of("batch"):
            if rows % (n * self.sizes[a]):
                break
            axes.append(a)
            n *= self.sizes[a]
        whole = tuple(a for a in self.free_axes if a not in axes)
        tokens = rows // n * seq
        if tokens % self.size(whole):
            raise ValueError(
                f"{rows} rows do not divide over {self.world} ranks "
                f"({self.free_axes}), and the {tokens} tokens of the "
                f"{rows // n} rows a rank holds over {tuple(axes)} do not "
                f"divide over the {self.size(whole)} ranks of {whole}")
        return dataclasses.replace(self, row_axes=tuple(axes))

    def _share(self, t: torch.Tensor, axes: tuple[str, ...],
               what: str) -> torch.Tensor:
        n = self.size(axes)
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} {what} do not divide over "
                             f"{n} ranks ({axes})")
        m = t.shape[0] // n
        i = self.index(axes)
        return t[i * m:(i + 1) * m]

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's equal share of dim 0 over the axes the rows are
        split over (:attr:`rows_over`; every free axis unless
        :meth:`split_rows` chose fewer)."""
        return self._share(t, self.rows_over, "rows")

    def local_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's equal share of dim 0 of a tensor over the step's
        flattened tokens (a [T, E] gate noise), over every free axis in
        :attr:`token_axes` order: the tokens of its rows, or its share
        of them where they are whole on several ranks."""
        return self._share(t, self.token_axes, "tokens")

    def shard_leaf(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's slice of a full tensor, in storage of its own (a
        replicated leaf is copied too: the optimizer updates shards in
        place)."""
        for dim, axes in enumerate(spec):
            if axes:
                n = self.size(axes)
                m = t.shape[dim] // n
                t = t.narrow(dim, self.index(axes) * m, m)
        return t.clone(memory_format=torch.contiguous_format)

    def gather_leaf(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The full tensor from this rank's slice (autograd-aware)."""
        for dim, axes in enumerate(spec):
            if axes:
                t = self.all_gather(t, axes, dim)
        return t

    def shard(self, tree, defs):
        """This rank's slices of a full tree, by the plan's specs of the
        ParamDef tree ``defs``; off-mesh the tree itself."""
        if self.mesh is None:
            return tree
        specs = self.specs(defs)
        return zip_map(lambda t, s: self.shard_leaf(t, s), tree, specs)

    def gather(self, tree, defs,
               keep: Callable[[ParamDef], bool] | None = None):
        """The full tree from this rank's slices, through an
        autograd-aware all-gather (its backward reduce-scatters the
        gradient); leaves whose def satisfies ``keep`` stay as they are.
        Off-mesh the tree itself."""
        if self.mesh is None:
            return tree

        def one(t, d):
            if keep is not None and keep(d):
                return t
            return self.gather_leaf(t, self.resolve(d.shape, d.axes))
        return zip_map(one, tree, defs)

    @torch.no_grad()
    def reshard(self, tree, defs):
        """Relay a materialized tree, whole on every rank, onto this
        context's plan: each rank keeps the slice that :meth:`resolve`
        gives for the leaf's def (the serving prefill_tp -> decode_std
        handoff of a finished page).  Off-mesh the tree itself."""
        return self.shard(tree, defs)

    # -- contextvar plumbing ---------------------------------------------
    def __enter__(self) -> "MeshContext":
        tokens = getattr(self, "_tokens", None)
        if tokens is None:
            tokens = []
            object.__setattr__(self, "_tokens", tokens)
        tokens.append(_CTX.set(self))
        return self

    def __exit__(self, *exc):
        _CTX.reset(getattr(self, "_tokens").pop())
        return False


def zip_map(fn, tree, other):
    """Map ``fn(leaf, other_leaf)`` over a nested dict and a tree of the
    same structure (sorted keys)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, tree[k], other[k]) for k in sorted(tree)}
    return fn(tree, other)


def _as_rules(plan) -> partition.ShardingRules:
    if isinstance(plan, str):
        return partition.PLANS[plan]
    return plan


def current_ctx() -> MeshContext | None:
    """The innermost active context (``with ctx:``), or ``None``."""
    return _CTX.get()


def on_mesh(ctx: MeshContext | None) -> bool:
    """Whether ``ctx`` has a mesh (None and the null context have not)."""
    return ctx is not None and ctx.mesh is not None


def local_draws(draws: dict, ctx: MeshContext,
                whole: Sequence[str] = (), rows: Sequence[str] = ()) -> dict:
    """This rank's share of one step's draws for the global batch: a
    token-indexed tensor's (a [T, E] gate noise) by ``ctx.local_tokens``,
    the keys in ``rows`` (a [B, S, d] dropout mask) by
    ``ctx.local_rows``, as the trainer takes the batch.  The keys in
    ``whole`` stay the global batch's (the noise of a layer that routes
    the global plan on every rank)."""
    def one(v, share):
        if isinstance(v, dict):
            return {k: one(t, share) for k, t in v.items()}
        if isinstance(v, list):
            return [one(t, share) for t in v]
        return None if v is None else share(v)
    return {k: v if k in whole else one(
        v, ctx.local_rows if k in rows else ctx.local_tokens)
            for k, v in draws.items()}


# The row split of the training step being run (``split_rows``'s
# axes), for the loss function it calls.
_STEP_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_step_rows", default=None)


@contextlib.contextmanager
def step_rows(ctx: MeshContext):
    """Within the block, :func:`with_step_rows` hands a loss function's
    context the row split of ``ctx`` (the trainer's microbatch)."""
    token = _STEP_ROWS.set(ctx.row_axes)
    try:
        yield
    finally:
        _STEP_ROWS.reset(token)


def with_step_rows(ctx: MeshContext) -> MeshContext:
    """``ctx`` with the row split of the enclosing :func:`step_rows`
    block, or ``ctx`` itself.  A loss function reads it once, as its
    forward pass starts, and passes the result down (a backward pass
    may run on another thread)."""
    axes = _STEP_ROWS.get()
    if axes is None or ctx.row_axes is not None:
        return ctx
    return dataclasses.replace(ctx, row_axes=axes)
