"""Training step (PyTorch), on one device or sharded over a mesh.

Port of ``retto_tpu/train/trainer.py:28-134``.  A
``TrainState`` holds the model (whose parameters and BatchNorm running
statistics are the state's params and batch stats), the optimizer with its
learning-rate schedule, and the step count.  The optimizer is AdamW over
every parameter with optax's ``adamw`` defaults (betas 0.9/0.999, eps 1e-8,
the weight decay scaled by the scheduled rate, as torch scales it), and the
schedule is ``optax.warmup_cosine_decay_schedule(0, lr, warmup, decay)``
(:func:`warmup_cosine_decay`), whose ``decay_steps`` includes the warmup.

Sharded training (``mesh=``) runs one process per card over a
``torch.distributed`` ``DeviceMesh`` with dims ``("data", "model")``
(``parallel.distributed.global_mesh``), the counterpart of XLA's SPMD step
over a ``('data', 'model')`` mesh.  Local shards and explicit collectives
stand in for JAX's declared shardings (DTensor would hide the same
collectives behind its dispatch; plain tensors keep every model's forward
and the optimizer as they are on one device):

* every rank takes the global batch and keeps its 'data' shard's rows
  (``with_sharding_constraint``); the forward's outputs are all-gathered
  over 'data' (autograd-aware), so the loss is the global batch's, the
  same on every rank, whatever the loss (the DB loss's hard-negative
  mining is not a mean over rows);
* BatchNorm takes the global batch's statistics (``models.common.
  BatchNorm.stats_group``), as the SPMD step's mean over a sharded axis;
* parameters that a rule of :func:`param_shardings` matches are split as
  its spec says.  A Dense kernel ``P(None, "model")`` (Flax ``[D, C]``)
  becomes this rank's rows of the torch ``[C, D]`` weight, an uneven split
  included (6,625 classes over 2: 3,313 + 3,312); the layer computes its
  logit columns and all-gathers them before the bias and the loss
  (:class:`ColumnShardedDense`).  Every other spec (a row split, a conv
  kernel, the attention kernels, a split over 'data', several axes on one
  dimension) stores this rank's block of the parameter and all-gathers
  the whole parameter where the layer reads it (:class:`_GatherParam`, a
  parametrization), so the layer's math is the unsharded one, as under
  pjit only the layout changes.  A 1-D bias stays whole, as JAX's
  ``ndim >= 2`` test leaves it;
* gradients are averaged over 'data' (each rank's backward carries the
  all-gathers' sums, so the average is the global batch's gradient); a
  gathered parameter's backward averages its gradient over 'data' and
  keeps this rank's block.  AdamW steps every parameter, the shards
  included.

The default rule is JAX's ``{"head": P(None, "model")}``.  It matches a
substring of each parameter's Flax path, and no shipped model has
``head`` in a path (the rec's CTC head is ``Dense_1``, the det's head
``DBHeadV2_0``): as in JAX, the default shards nothing, and tensor
parallelism needs an explicit rule such as ``{"Dense_1": P(None,
"model")}``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.common import BatchNorm, Dense, _compute_params
from ..parallel.mesh import P, PartitionSpec, make_mesh  # make_mesh: re-export
from ..weights.convert import flax_param_paths

__all__ = [
    "TrainState",
    "init_train_state",
    "make_mesh",
    "make_train_step",
    "param_shardings",
    "warmup_cosine_decay",
]

DEFAULT_RULES = {"head": P(None, "model")}


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int
                        ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)``: the rate at update ``count`` (0 for the first): linear
    from 0 to ``peak`` over ``warmup_steps``, then a cosine from ``peak``
    to 0 over the remaining ``decay_steps - warmup_steps``, 0 after."""
    span = decay_steps - warmup_steps

    def lr_at(count: int) -> float:
        if warmup_steps > 0 and count < warmup_steps:
            return peak * count / warmup_steps
        t = min(max(count - warmup_steps, 0), span) / span if span > 0 else 1.0
        return peak * 0.5 * (1.0 + math.cos(math.pi * t))

    return lr_at


@dataclass
class TrainState:
    """The model (params and batch stats), its optimizer and schedule, and
    the number of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


# Each Flax dimension's torch dimension, by parameter: a Dense kernel
# [in, out] is the [out, in] weight, a conv's HWIO the OIHW weight, the
# attention's query/key/value kernels [D, H, Dh] rows of ``in_proj_weight``
# [3D, D] (their [H, Dh] biases of ``in_proj_bias``), its output kernel
# [H, Dh, D] the [D, H*Dh] ``out_proj.weight``.
_TORCH_DIMS = {"in_proj_weight": (1, 0, 0), "in_proj_bias": (0, 0),
               "out_proj.weight": (1, 1, 0)}
_TORCH_DIMS_BY_RANK = {2: (1, 0), 4: (2, 3, 1, 0)}


def _torch_spec(flax_spec: PartitionSpec, name: str, ndim: int) -> PartitionSpec:
    """A Flax leaf's spec in its torch parameter's layout.  Flax dimensions
    that fold into one torch dimension (heads and head width) give it
    their axes in order, outer first, as a tuple."""
    if len(flax_spec) > ndim:
        raise ValueError(f"spec {flax_spec} has more entries than {name}'s rank {ndim}")
    dims = next((d for k, d in _TORCH_DIMS.items() if name.endswith(k)), None)
    dims = dims or _TORCH_DIMS_BY_RANK[ndim]
    axes: list[tuple[str, ...]] = [() for _ in range(max(dims) + 1)]
    for i, entry in enumerate(tuple(flax_spec)):
        axes[dims[i]] += (entry,) if isinstance(entry, str) else tuple(entry or ())
    return P(*(None if not a else a[0] if len(a) == 1 else a for a in axes))


def _axis_names(mesh) -> tuple[str, ...]:
    return tuple(getattr(mesh, "mesh_dim_names", None) or mesh.axis_names)


def param_shardings(model: nn.Module, mesh, rules: Mapping[str, PartitionSpec] | None = None
                    ) -> dict[str, PartitionSpec]:
    """Each parameter's spec in the torch layout (``P()`` replicated) by
    ``rules``, as JAX's ``param_shardings``: a parameter whose Flax path
    (``"Dense_1/kernel"``) contains a rule's substring, and whose Flax leaf
    has rank >= 2, takes the first such rule's spec.  Default rule
    ``{"head": P(None, "model")}``.  ``mesh`` (a ``DeviceMesh`` or a
    ``parallel.mesh.Mesh``) must have every axis the specs name.  A torch
    parameter that holds several Flax leaves (``in_proj_weight``: the
    query, key and value kernels) takes the spec of the first leaf a rule
    matches, for the whole parameter."""
    rules = DEFAULT_RULES if rules is None else rules
    names = _axis_names(mesh)
    out = {name: P() for name, _ in model.named_parameters()}
    for path, (name, ndim) in flax_param_paths(model).items():
        for frag, spec in rules.items():
            if frag in path and ndim >= 2:
                used = [a for e in spec for a in ((e,) if isinstance(e, str) else e or ())]
                if any(a not in names for a in used) or len(set(used)) < len(used):
                    raise ValueError(f"rule {frag!r}: {spec} must name each of {names} "
                                     "at most once")
                if not any(out[name]):
                    out[name] = _torch_spec(spec, name, ndim)
                break
    return out


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``
    (the input of a layer whose output columns are split over it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    """All-gather the last dim over ``group`` (``sizes``: each rank's
    columns, padded to the largest for the collective); the backward keeps
    this rank's columns (every rank of the group computes the same loss)."""

    @staticmethod
    def forward(ctx, y, group, sizes, index):
        ctx.lo, ctx.hi = sum(sizes[:index]), sum(sizes[:index + 1])
        width = max(sizes)
        y = F.pad(y, (0, width - y.shape[-1])).contiguous()
        parts = [torch.empty_like(y) for _ in sizes]
        dist.all_gather(parts, y, group=group)
        return torch.cat([t[..., :n] for t, n in zip(parts, sizes)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.hi].contiguous(), None, None, None


class ColumnShardedDense(Dense):
    """A ``Dense`` whose output features are split over the mesh's 'model'
    group: ``weight`` holds this rank's rows of the ``[out, in]`` weight,
    ``bias`` all of it.  The forward computes the local columns in the
    compute dtype, all-gathers them and adds the bias, the ops of
    ``Dense.forward`` on the gathered product."""

    def __init__(self, dense: Dense, group, sizes: list[int], index: int):
        lo = sum(sizes[:index])
        super().__init__(dense.in_features, sizes[index], bias=False)
        with torch.no_grad():
            self.weight = nn.Parameter(dense.weight[lo:lo + sizes[index]].clone())
        self.bias = dense.bias
        self.compute_dtype = dense.compute_dtype
        self.group, self.sizes, self.index = group, sizes, index

    def forward(self, x: torch.Tensor, f32_out: bool = False) -> torch.Tensor:
        w, b = _compute_params(self)
        y = F.linear(_CopyToGroup.apply(x.to(w.dtype), self.group), w)
        y = _GatherColumns.apply(y, self.group, self.sizes, self.index)
        if f32_out:
            return y.float() + b.float()
        return y + b


class _GatherParam(nn.Module):
    """A parametrization (``torch.nn.utils.parametrize``) that stores this
    rank's block of a parameter split by ``spec`` (torch layout) and
    returns the whole parameter, all-gathered, where the layer reads it.
    Its backward averages the gradient over 'data' (each rank's carries
    its own rows' share, as :func:`_average_grads` takes it) and keeps this
    rank's block."""

    def __init__(self, shape: torch.Size, spec: PartitionSpec, mesh):
        super().__init__()
        names = _axis_names(mesh)
        self.data_group = mesh.get_group("data")
        self.n_data = mesh.size(names.index("data"))
        # (dim, group, every rank's size, this rank's index), the innermost
        # axis of a dimension first: the order of the gathers
        self.plan: list[tuple[int, Any, list[int], int]] = []
        for dim, entry in enumerate(tuple(spec)):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if not axes:
                continue
            counts = [mesh.size(names.index(a)) for a in axes]
            chunks = [len(c) for c in torch.arange(shape[dim]).tensor_split(math.prod(counts))]
            for j in reversed(range(len(axes))):
                inner = math.prod(counts[j + 1:])
                n = counts[j]
                # the sizes after the gathers of the axes inside this one
                sizes = [sum(chunks[i:i + inner]) for i in range(0, len(chunks), inner)]
                pos = 0  # this rank's block of the axes outside this one
                for k, a in enumerate(axes[:j]):
                    pos = pos * counts[k] + mesh.get_local_rank(a)
                self.plan.append((dim, mesh.get_group(axes[j]), sizes[pos * n:(pos + 1) * n],
                                  mesh.get_local_rank(axes[j])))

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(shard, self.plan, self.data_group, self.n_data)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        for dim, _, sizes, index in reversed(self.plan):
            full = full.narrow(dim, sum(sizes[:index]), sizes[index])
        return full.contiguous()


class _Gather(torch.autograd.Function):
    """:class:`_GatherParam`'s all-gathers along each ``plan`` step (each
    rank's block padded to the largest for the collective)."""

    @staticmethod
    def forward(ctx, x, plan, data_group, n_data):
        ctx.plan, ctx.data_group, ctx.n_data = plan, data_group, n_data
        for dim, group, sizes, _ in plan:
            pad = [0, 0] * (x.dim() - 1 - dim) + [0, max(sizes) - x.shape[dim]]
            y = F.pad(x, pad).contiguous()
            parts = [torch.empty_like(y) for _ in sizes]
            dist.all_gather(parts, y, group=group)
            x = torch.cat([t.narrow(dim, 0, n) for t, n in zip(parts, sizes)], dim=dim)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.data_group)
        g /= ctx.n_data
        for dim, _, sizes, index in reversed(ctx.plan):
            g = g.narrow(dim, sum(sizes[:index]), sizes[index])
        return g.contiguous(), None, None, None


def _shard_model(model: nn.Module, mesh, rules) -> None:
    """Apply ``param_shardings`` to ``model`` in place for this rank, and
    point every BatchNorm at the 'data' group."""
    from torch.nn.utils import parametrize

    data_group = mesh.get_group("data")
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.stats_group = data_group
    specs = param_shardings(model, mesh, rules)
    n_model, index = mesh.size(_axis_names(mesh).index("model")), mesh.get_local_rank("model")
    for name, spec in specs.items():
        if not any(spec):
            continue
        path, _, leaf = name.rpartition(".")
        owner = model.get_submodule(path)
        if leaf == "weight" and isinstance(owner, Dense) and spec == P("model", None):
            sizes = [len(c) for c in torch.arange(owner.out_features).tensor_split(n_model)]
            parent, _, attr = path.rpartition(".")
            setattr(model.get_submodule(parent), attr,
                    ColumnShardedDense(owner, mesh.get_group("model"), sizes, index))
            continue
        param = getattr(owner, leaf)
        parametrize.register_parametrization(owner, leaf,
                                             _GatherParam(param.shape, spec, mesh), unsafe=True)
        getattr(owner.parametrizations, leaf).original.data_averaged = True


def init_train_state(model: nn.Module, lr: float | Callable[[int], float],
                     weight_decay: float = 1e-4,
                     device: str | torch.device | None = None,
                     mesh=None, rules: Mapping[str, PartitionSpec] | None = None) -> TrainState:
    """Move ``model`` (float32 parameters, initialised by torch or loaded
    from a checkpoint) to ``device``, put it in training mode and give it
    AdamW over every parameter with a constant rate or a schedule ``count
    -> rate`` (:func:`warmup_cosine_decay`), as optax's ``adamw(schedule,
    weight_decay=...)``.

    With ``mesh`` (a ``DeviceMesh`` with dims ``("data", "model")``; the
    process group formed) the model's state is first broadcast from rank
    0, so every replica starts equal; ``device`` defaults to this rank's
    card (the CPU for a gloo mesh); BatchNorm takes global statistics and
    the parameters ``param_shardings(model, mesh, rules)`` matches are
    split over 'model' (module docstring)."""
    if mesh is not None and device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    if device is not None:
        model.to(device)
    if mesh is not None:
        with torch.no_grad():
            for t in model.state_dict().values():
                dist.broadcast(t, src=0)
        _shard_model(model, mesh, rules)
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = lr if callable(lr) else (lambda count: lr)
    return TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, sched), 0)


class _GatherRows(torch.autograd.Function):
    """All-gather dim 0 over ``group`` (equal shards, in group rank
    order); the backward sums each rank's gradient of this rank's rows
    over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(dist.get_world_size(ctx.group))[dist.get_rank(ctx.group)], None


def _gather_rows(out: Any, group) -> Any:
    """The forward's outputs (a tensor, or a dict, tuple or list of them)
    all-gathered over ``group`` along dim 0, autograd-aware."""
    if isinstance(out, torch.Tensor):
        return _GatherRows.apply(out, group)
    if isinstance(out, dict):
        return {k: _gather_rows(v, group) for k, v in out.items()}
    return type(out)(_gather_rows(v, group) for v in out)


def _average_grads(model: nn.Module, group) -> None:
    """Each gradient averaged over ``group``, in one all-reduce."""
    grads = [p.grad for p in model.parameters()
             if p.grad is not None and not getattr(p, "data_averaged", False)]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    torch._foreach_copy_(grads, [t.view_as(g) for t, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def make_train_step(model: nn.Module, loss_fn: Callable[..., torch.Tensor],
                    forward: Callable[[nn.Module, torch.Tensor], Any] | None = None,
                    mesh=None):
    """A train step ``step(state, x, *rest) -> (state, loss)``: the model's
    training forward (``forward(model, x)``, default ``model(x)``), then
    ``loss_fn(output, *rest)``, its gradients, and one optimizer and
    schedule step.  The loss comes back as a detached tensor on the
    device.

    With ``mesh`` (the ``DeviceMesh`` the state was initialised with) the
    step is sharded as the module docstring says: ``x`` is the global
    batch, of which this rank runs its 'data' shard's rows (the 'data' size
    must divide the batch), ``rest`` the global batch's targets; the loss
    is the global batch's."""
    fwd = forward or (lambda m, x: m(x))
    if mesh is not None:
        data_group = mesh.get_group("data")
        n_data = mesh.size(_axis_names(mesh).index("data"))
        index = dist.get_rank(data_group)  # the gather's row order

    def step(state: TrainState, x: torch.Tensor, *rest) -> tuple[TrainState, torch.Tensor]:
        model.train()
        if mesh is None:
            loss = loss_fn(fwd(model, x), *rest)
        else:
            if x.shape[0] % n_data:
                raise ValueError(f"batch of {x.shape[0]} does not split over {n_data} 'data' ranks")
            out = fwd(model, x.chunk(n_data)[index])
            loss = loss_fn(_gather_rows(out, data_group), *rest)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            _average_grads(model, data_group)
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return state, loss.detach()

    return step
