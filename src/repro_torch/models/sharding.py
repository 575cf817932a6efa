"""Logical-axis sharding rules (``repro.models.sharding`` on PyTorch).

Model code names the axes of its tensors with *logical* names ("batch",
"heads", …); `use_rules` installs, for one mesh, the table that maps them
to mesh axes.  Outside any mesh every annotation is a no-op, so models
run unmodified on one device.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (or, for the
spec functions alone, any object with its ``mesh_dim_names`` and
``shape``).  `logical_spec`, `_axis_size`, `named_sharding` and the rule
table are the reference's.  What moves a tensor differs: under XLA a
sharding constraint lets the compiler place the collectives, while here
each rank holds plain local tensors (its shard) and the collectives are
explicit.  So the port's `constrain` takes, besides the target axes, the
layout the tensor has now (``src``) and whether it holds partial sums
(``partial``), and moves it over the mesh:

  * an axis that ``src`` shards and the target does not: all-gather;
  * partial sums: reduce-scatter onto a dimension the target shards over
    the partial axis, else all-reduce;
  * an axis the target shards and ``src`` does not: each rank keeps its
    slice.

The target keeps the reference's divisibility guard: a dimension the axis
extent does not divide stays replicated.  Inside a forward only the model
axis moves: the data axes hold the loader's rows throughout.

Gradients follow from one convention, Megatron's: the gradient a rank
holds for a tensor *replicated* over an axis is that rank's partial
contribution, and the gradient of a *sharded* or *partial* tensor is
whole.  Each collective's backward is then its adjoint (all-gather ↔
reduce-scatter, all-reduce ↔ all-reduce, slice ↔ zero padding), and the
train step sums each parameter's gradient over the mesh axes its spec
does not shard (`train.step`).  A value computed identically on every
rank of an axis and fed straight to the loss (the MoE aux loss) takes
``scale_grad(x, 1/n)``.

All-gather and reduce-scatter are the backend's own where it carries
them for the tensor's device (NCCL; gloo for CPU tensors).  gloo reduces
CUDA tensors but gathers none, so there the two are built on
``all_reduce``; two gloo ranks on one card are how a single-card machine
checks the arithmetic.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["AxisRules", "DEFAULT_RULES", "PartitionSpec", "P", "use_rules",
           "current_mesh", "logical_spec", "constrain", "named_sharding",
           "NamedSharding", "axis_sizes", "axis_index", "all_gather",
           "reduce_scatter", "all_reduce", "extent", "psum_logical",
           "scale_grad", "vocab_parallel_xent", "shard_parameters_"]

AxisRules = Dict[str, Union[None, str, Tuple[str, ...]]]

# The reference's production rules.  "pod" is a pure-DP outer axis.
DEFAULT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "residual": "model",     # Megatron-SP: residual stream seq-sharded
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "capacity": None,
    "kv_seq": "model",       # decode-time KV cache sequence sharding
    "nodes": ("pod", "data"),  # GNN graphs
    "edge_chunk": ("pod", "data"),
    "hidden": None,
    "table_rows": "model",   # DLRM embedding-table row sharding
    "feature": None,
    "roots": ("pod", "data", "model"),  # FLEXIS match roots: whole mesh
}


class PartitionSpec:
    """JAX's ``PartitionSpec``: one entry a dimension, each None
    (replicated), a mesh axis name or a tuple of them; trailing
    dimensions past the spec are replicated.  Not a tuple, so that tree
    walks (``train.checkpoint.tree_flatten``) take it as a leaf."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(tuple(p) if isinstance(p, list) else p
                           for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"P{self.parts!r}"


P = PartitionSpec


class _Ctx(threading.local):
    def __init__(self):
        self.rules: Optional[AxisRules] = None
        self.mesh = None


_CTX = _Ctx()


@contextlib.contextmanager
def _installed(rules: Optional[AxisRules], mesh):
    prev = (_CTX.rules, _CTX.mesh)
    _CTX.rules, _CTX.mesh = rules, mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = prev


def use_rules(mesh, rules: Optional[AxisRules] = None):
    """Install sharding rules for ``mesh`` in this thread (mesh axes not in
    the rule target are dropped, so one table serves 2-D and 3-D
    meshes)."""
    return _installed(dict(DEFAULT_RULES, **(rules or {})), mesh)


def captured_rules():
    """A context that installs, in the thread entering it, the rules and
    mesh in force in this thread now (and gives that thread its own back on
    exit).  Recomputation (``common.remat``) reruns a forward inside the
    backward — on the card in autograd's device thread, where `use_rules`
    was never entered — and needs the forward's layouts and collectives."""
    return _installed(_CTX.rules, _CTX.mesh)


def current_mesh():
    return _CTX.mesh


def axis_sizes(mesh) -> Dict[str, int]:
    """{mesh axis name: extent}."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def logical_spec(*axes: Optional[str]) -> PartitionSpec:
    """PartitionSpec for a sequence of logical axis names (None =
    replicated)."""
    rules = _CTX.rules or DEFAULT_RULES
    mesh = _CTX.mesh
    names = set(mesh.mesh_dim_names) if mesh is not None else set()
    parts = []
    used: set = set()
    for ax in axes:
        tgt = rules.get(ax) if ax is not None else None
        if tgt is None:
            parts.append(None)
            continue
        if isinstance(tgt, str):
            tgt = (tgt,)
        eff = tuple(t for t in tgt if t in names and t not in used)
        used |= set(eff)
        if len(eff) == 0:
            parts.append(None)
        elif len(eff) == 1:
            parts.append(eff[0])
        else:
            parts.append(eff)
    return P(*parts)


def _axis_size(mesh, part) -> int:
    sizes = axis_sizes(mesh)
    if isinstance(part, (tuple, list)):
        n = 1
        for p in part:
            n *= sizes.get(p, 1)
        return n
    return sizes.get(part, 1)


def _axes_of(part) -> tuple:
    """The mesh axes of a spec entry (None, a name or a tuple of names)."""
    return () if part is None else (part,) if isinstance(part, str) \
        else tuple(part)


def axis_index(mesh, part) -> int:
    """This rank's index along ``part`` (an axis or a tuple of axes,
    row-major), 0 for None."""
    idx = 0
    for a in _axes_of(part):
        if a in mesh.mesh_dim_names:
            idx = idx * _axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def _parts(spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def _guarded(shape, spec, mesh) -> PartitionSpec:
    """``spec`` with every part whose extent does not divide its dimension
    dropped (the reference's divisibility guard)."""
    return P(*[p if p is None or d % _axis_size(mesh, p) == 0 else None
               for d, p in zip(shape, _parts(spec, len(shape)))])


# ---------------------------------------------------------------------------
# collectives over one mesh axis (no autograd), then their autograd pairs
# ---------------------------------------------------------------------------

def _native(group, t: torch.Tensor) -> bool:
    """Whether ``group``'s backend gathers and reduce-scatters ``t``'s
    device itself."""
    backend = dist.get_backend(group)
    return backend == "nccl" or (backend == "gloo" and t.device.type == "cpu")


def _gather_raw(t: torch.Tensor, dim: int, mesh, axis: str,
                native: Optional[bool] = None) -> torch.Tensor:
    """Every rank's ``t`` of ``axis`` concatenated along ``dim``;
    ``native`` (default: `_native`) picks the backend's all-gather over
    the ``all_reduce`` of zero-padded pieces."""
    n = _axis_size(mesh, axis)
    if n == 1:
        return t
    group, t = mesh.get_group(axis), t.detach()
    dim = dim % t.dim()
    if _native(group, t) if native is None else native:
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    shape = list(t.shape)
    shape[dim] *= n
    out = t.new_zeros(shape)
    out.narrow(dim, axis_index(mesh, axis) * t.shape[dim],
               t.shape[dim]).copy_(t)
    dist.all_reduce(out, group=group)
    return out


def _reduce_scatter_raw(t: torch.Tensor, dim: int, mesh, axis: str,
                        native: Optional[bool] = None) -> torch.Tensor:
    """The sum of the ranks' ``t`` over ``axis``, this rank's slice of
    ``dim``; ``native`` as in `_gather_raw`."""
    n = _axis_size(mesh, axis)
    if n == 1:
        return t
    group, t = mesh.get_group(axis), t.detach()
    dim = dim % t.dim()
    if t.shape[dim] % n:
        raise ValueError(f"reduce-scatter of dim {dim} ({t.shape[dim]}) over "
                         f"{n} ranks of {axis!r}")
    if _native(group, t) if native is None else native:
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    buf = t.contiguous().clone()
    dist.all_reduce(buf, group=group)
    size = t.shape[dim] // n
    return buf.narrow(dim, axis_index(mesh, axis) * size, size).contiguous()


def _all_reduce_raw(t: torch.Tensor, mesh, axis: str, op=None) -> torch.Tensor:
    if _axis_size(mesh, axis) == 1:
        return t
    buf = t.contiguous().clone()
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM,
                    group=mesh.get_group(axis))
    return buf


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = (dim, mesh, axis)
        return _gather_raw(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_raw(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = (dim, mesh, axis)
        return _reduce_scatter_raw(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, *ctx.args), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _all_reduce_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, *ctx.args), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def all_gather(x: torch.Tensor, dim: int, axis: str = "model",
               mesh=None) -> torch.Tensor:
    """Concatenate every rank's ``x`` of ``axis`` along ``dim``; backward
    reduce-scatter."""
    mesh = _CTX.mesh if mesh is None else mesh
    if mesh is None or _axis_size(mesh, axis) == 1:
        return x
    return _AllGather.apply(x, dim, mesh, axis)


def reduce_scatter(x: torch.Tensor, dim: int, axis: str = "model",
                   mesh=None) -> torch.Tensor:
    """Sum the ranks' ``x`` over ``axis`` and keep this rank's slice of
    ``dim``; backward all-gather."""
    mesh = _CTX.mesh if mesh is None else mesh
    if mesh is None or _axis_size(mesh, axis) == 1:
        return x
    return _ReduceScatter.apply(x, dim, mesh, axis)


def all_reduce(x: torch.Tensor, axis: str = "model", mesh=None
               ) -> torch.Tensor:
    """Sum the ranks' ``x`` over ``axis``; backward all-reduce."""
    mesh = _CTX.mesh if mesh is None else mesh
    if mesh is None or _axis_size(mesh, axis) == 1:
        return x
    return _AllReduce.apply(x, mesh, axis)


def extent(logical: str) -> int:
    """How many ranks the logical axis spreads over (1 outside a mesh)."""
    mesh = _CTX.mesh
    if mesh is None:
        return 1
    part = logical_spec(logical)[0]
    return 1 if part is None else _axis_size(mesh, part)


def psum_logical(x: torch.Tensor, logical: str) -> torch.Tensor:
    """`all_reduce` of ``x`` over every mesh axis of a logical axis."""
    mesh = _CTX.mesh
    for a in _axes_of(logical_spec(logical)[0] if mesh is not None
                      else None):
        x = all_reduce(x, a, mesh)
    return x


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x``, with its gradient multiplied by ``s``."""
    return x if s == 1 else _ScaleGrad.apply(x, s)


def _single(part, mesh) -> str:
    axes = _axes_of(part)
    moving = [a for a in axes if _axis_size(mesh, a) > 1]
    if len(moving) > 1:
        raise NotImplementedError(f"constrain moves one mesh axis at a "
                                  f"time, not {part}")
    return moving[0] if moving else axes[0]


def constrain(x: torch.Tensor, *axes: Optional[str], src=None,
              partial: Optional[str] = None) -> torch.Tensor:
    """Move ``x`` to the layout of the logical ``axes`` (module doc); a
    no-op outside a mesh, and when neither ``src`` (the logical axes of
    x's current layout) nor ``partial`` (the mesh axis x holds partial
    sums over) is given: the local computation produced the layout.
    With ``partial`` alone, x is laid out as the target but for the
    dimension the partial axis splits there."""
    mesh = _CTX.mesh
    if mesh is None or (src is None and partial is None):
        return x
    if src is None:     # partial sums, laid out as the target elsewhere
        srcs = [None if partial in _axes_of(p) else p
                for p in _parts(logical_spec(*axes), x.dim())]
    else:
        srcs = _parts(logical_spec(*src), x.dim())
    glob = [d * _axis_size(mesh, s) if s is not None else d
            for d, s in zip(x.shape, srcs)]
    dsts = _parts(_guarded(glob, logical_spec(*axes), mesh), x.dim())
    for i, (s, d) in enumerate(zip(srcs, dsts)):
        if s is not None and s != d:
            x = all_gather(x, i, _single(s, mesh), mesh)
    done = set()
    if partial is not None:
        onto = [i for i, (s, d) in enumerate(zip(srcs, dsts))
                if s != d and _axes_of(d) == (partial,)]
        if onto:
            x = reduce_scatter(x, onto[0], partial, mesh)
            done.add(onto[0])
        else:
            x = all_reduce(x, partial, mesh)
    for i, (s, d) in enumerate(zip(srcs, dsts)):
        if d is not None and s != d and i not in done:
            a = _single(d, mesh)
            n = x.shape[i] // _axis_size(mesh, a)
            x = x.narrow(i, axis_index(mesh, a) * n, n)
    return x


class _VocabParallelXent(torch.autograd.Function):
    """Per-token ``logsumexp − gold`` of f32 logits whose vocabulary is
    split over a mesh axis (Megatron's vocab-parallel cross-entropy): max,
    exp-sum and gold logit reduced over the axis; the backward writes
    softmax − one-hot into this rank's slice.  The loss is replicated over
    the axis and its gradient taken whole on each rank."""

    @staticmethod
    def forward(ctx, logits, targets, mesh, axis):
        V = logits.shape[-1]
        lo = axis_index(mesh, axis) * V
        m = _all_reduce_raw(logits.amax(dim=-1), mesh, axis,
                            op=dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        z = _all_reduce_raw(e.sum(dim=-1), mesh, axis)
        t = targets.long() - lo
        mine = (t >= 0) & (t < V)
        tl = torch.where(mine, t, torch.zeros_like(t))
        gold = torch.gather(logits, -1, tl[..., None])[..., 0]
        gold = _all_reduce_raw(torch.where(mine, gold, torch.zeros_like(gold)),
                               mesh, axis)
        ctx.save_for_backward(e / z[..., None], tl, mine)
        return torch.log(z) + m - gold

    @staticmethod
    def backward(ctx, g):
        probs, tl, mine = ctx.saved_tensors
        grad = probs * g[..., None]
        hit = torch.where(mine, g, torch.zeros_like(g))
        grad = grad.scatter_add(-1, tl[..., None], -hit[..., None])
        return grad, None, None, None


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor,
                        axis: str = "model", mesh=None) -> torch.Tensor:
    """(…, V/n) f32 logits of this rank's vocabulary slice → (…,) f32
    ``logsumexp − gold`` over the whole vocabulary."""
    mesh = _CTX.mesh if mesh is None else mesh
    return _VocabParallelXent.apply(logits, targets, mesh, axis)


# ---------------------------------------------------------------------------
# placing whole tensors: what a parameter, a moment or a restored leaf holds
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor laid out over ``mesh`` by ``spec`` (mesh axis names)."""
    mesh: Any
    spec: PartitionSpec

    def local_shape(self, shape) -> Tuple[int, ...]:
        out = []
        for d, p in zip(shape, _parts(self.spec, len(shape))):
            n = _axis_size(self.mesh, p) if p is not None else 1
            if d % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split over {p} ({n}) in {self.spec}")
            out.append(d // n)
        return tuple(out)

    def global_shape(self, local_shape) -> Tuple[int, ...]:
        """The whole tensor's shape, from a shard's."""
        return tuple(d * (_axis_size(self.mesh, p) if p is not None else 1)
                     for d, p in zip(local_shape,
                                     _parts(self.spec, len(local_shape))))

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor ``t`` (contiguous; ``t``
        itself when nothing is split)."""
        local = self.local_shape(t.shape)
        if local == tuple(t.shape):
            return t
        for i, (p, n) in enumerate(zip(_parts(self.spec, t.dim()), local)):
            if p is not None:
                t = t.narrow(i, axis_index(self.mesh, p) * n, n)
        return t.contiguous()

    def unshard(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's piece ``t`` (a collective:
        every rank of the mesh calls it)."""
        for i, p in enumerate(_parts(self.spec, t.dim())):
            for a in reversed(_axes_of(p)):   # row-major: inner axis first
                t = _gather_raw(t, i, self.mesh, a)
        return t


def named_sharding(*axes: Optional[str]) -> Optional[NamedSharding]:
    if _CTX.mesh is None:
        return None
    return NamedSharding(_CTX.mesh, logical_spec(*axes))


def shard_parameters_(module: torch.nn.Module, specs, mesh, *,
                      prefix: str = "", recurse: bool = True) -> None:
    """Replace each parameter of ``module`` (named ``prefix + name`` in
    ``specs``) by this rank's shard of it, in place; a parameter that
    nothing splits is kept as it is."""
    for name, p in list(module.named_parameters(recurse=recurse)):
        local = NamedSharding(mesh, specs[prefix + name]).shard(p.data)
        if local is p.data:
            continue
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        mod._parameters[leaf] = torch.nn.Parameter(
            local, requires_grad=p.requires_grad)
