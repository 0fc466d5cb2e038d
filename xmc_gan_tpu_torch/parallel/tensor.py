"""Tensor parallelism over the model group (port of the JAX package's ``model``
mesh axis: ``xmc_gan_tpu/parallel/mesh.py``'s ``state_shardings``, whose
compute GSPMD partitions there).

**Layout** (``state_shardings``).  The JAX rule, applied to each leaf's JAX
shape: a leaf of at least ``tp_min_size`` elements whose trailing
(output-feature) axis ``tp`` divides is split on that axis over ``model``;
everything else is replicated, and Adam's moments follow their parameter.
The JAX trailing axis is dim 0 of the port's conv weight ``[O, I/g, kH, kW]``
(HWIO there) and dense weight ``[out, in]`` (``[in, out]`` there); of a
grouped dense weight ``[g*f, d_in, 1, 1]`` (``[g, d_in, f]`` there) it is
``f``, so dim 0 splits as ``[g, f]`` on its second axis (``RowShard.outer``).
Spectral vectors and biases follow their own JAX leaves.

**Compute** (``ColumnShard``, the seam of ``ops/modules.py``'s ``_SNBase``).
A layer whose weight is split keeps only its ``O/tp`` output rows (and their
Adam moments) and computes only those output features, column-parallel:

    x -> copy_to_model -> W_r (spectral: / sigma) -> gather_from_model -> + bias

Everything downstream of the gather is replicated within the model group,
each rank computing it in full, as each rank does upstream.  Where a grouped
conv's shard does not cover whole groups the weight shard is gathered
instead and the whole output computed.

**Gradients.**  Within the model group a replicated value's cotangent is the
whole one on every rank (each rank differentiates the same replicated loss).
Four Functions keep that so, each backward built of the others, so that a
double backward (MAGP's ``create_graph=True``) differentiates through them:

* ``copy_to_model``: identity forward; backward the cotangent summed over the
  model group (each rank's ``W_r^T dy_r`` is a part of ``dx``).
* ``_Sum``: the sum forward; backward the cotangent as it is (its output is
  replicated, so its cotangent is whole already).
* ``gather_from_model``: all-gather along the feature axis forward; backward
  this rank's slice of the (whole) cotangent.
* ``_Slice``: this rank's slice forward; backward the all-gather.

``reduce_over_model`` = ``copy_to_model(_Sum(x))``: the sum forward and the
sum backward, for a replicated value used by each rank's own rows (a spectral
``sigma = sum_r u_r . (W_r v)``).  A sharded weight's gradient is thus its
own rows' and a replicated leaf's is whole and alike across the model
group; the train step averages the first over the data group and the
second over every rank (the same mean, and bit-equal replicas where the
card's kernels are not deterministic).

Every model-group collective gathers raw bytes (any dtype, bit-exact) or
sums in fp32 (bf16 and fp16 are widened), so the ranks of a model group end
with the same bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn

from xmc_gan_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "RowShard",
    "ColumnShard",
    "copy_to_model",
    "reduce_over_model",
    "gather_from_model",
    "state_shardings",
    "shard_model",
    "shard_state",
    "sharded_tensors",
    "gather_state",
    "load_state",
    "refresh_sharded_spectral",
]

_WIDEN = (torch.bfloat16, torch.float16)


# ----------------------------------------------------------- collectives


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A 1-D view of a dense tensor's memory (any stride order)."""
    order = sorted(range(t.dim()), key=lambda i: -t.stride(i))
    return t.permute(order).view(-1)


def _exchange(flat: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every model rank's 1-D ``flat``, in rank order; the bytes cross as
    they are."""
    raw = flat.view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(mesh.tp)]
    dist.all_gather(parts, raw, group=mesh.model_group)
    return [p.view(flat.dtype) for p in parts]


def _summed(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the model group (fp32 for bf16/fp16, rounded
    once), in x's dtype and memory format."""
    buf = torch.empty_like(x, dtype=torch.float32 if x.dtype in _WIDEN else x.dtype)
    buf.copy_(x)
    dist.all_reduce(_flat(buf), group=mesh.model_group)
    return buf.to(x.dtype)


def _gathered(x: torch.Tensor, mesh: Mesh, dim: int, outer: int) -> torch.Tensor:
    """Every model rank's ``x`` joined along ``dim``, that axis read as
    ``[outer, n]`` with the ranks' parts side by side on ``n``."""
    src = x.movedim(dim, -1).contiguous()  # channels_last NCHW, dim 1: no copy
    parts = [p.view(src.shape).unflatten(-1, (outer, -1)) for p in _exchange(src.view(-1), mesh)]
    return torch.cat(parts, -1).flatten(-2).movedim(-1, dim)


def _sliced(x: torch.Tensor, mesh: Mesh, dim: int, outer: int) -> torch.Tensor:
    """This model rank's part of ``x`` along ``dim`` (``_gathered``'s inverse)."""
    src = x.movedim(dim, -1)
    k = src.shape[-1] // (outer * mesh.tp)
    m = mesh.model_rank
    part = src.unflatten(-1, (outer, -1))[..., m * k:(m + 1) * k].flatten(-2)
    return part.contiguous().movedim(-1, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.mesh), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _summed(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.mesh), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, outer):
        ctx.args = (mesh, dim, outer)
        return _gathered(x, mesh, dim, outer)

    @staticmethod
    def backward(ctx, g):
        return _Slice.apply(g, *ctx.args), None, None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, outer):
        ctx.args = (mesh, dim, outer)
        return _sliced(x, mesh, dim, outer)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, *ctx.args), None, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` (replicated over the model group) as the input of this rank's
    part: identity forward, the cotangent summed over the group backward."""
    return _Copy.apply(x, mesh)


def reduce_over_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every model rank's ``x``, for use by each rank's own part:
    the sum forward and backward."""
    return _Copy.apply(_Sum.apply(x, mesh), mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int, outer: int = 1) -> torch.Tensor:
    """Every model rank's part joined along ``dim`` (read as ``[outer,
    n]``, the parts side by side on ``n``), replicated; backward this
    rank's slice."""
    return _Gather.apply(x, mesh, dim, outer)


# ------------------------------------------------------------------ layout


@dataclass(frozen=True)
class RowShard:
    """Dim 0 of a tensor read as ``[outer, rows]``, ``rows`` split in ``tp``
    contiguous parts: model rank ``m`` holds part ``m`` of every outer block
    (``outer`` = 1: the rows ``[m*O/tp, (m+1)*O/tp)``)."""

    tp: int
    outer: int = 1

    def take(self, t: torch.Tensor, m: int) -> torch.Tensor:
        k = t.shape[0] // (self.outer * self.tp)
        return t.unflatten(0, (self.outer, -1))[:, m * k:(m + 1) * k].flatten(0, 1)


def _jax_shapes(layer: nn.Module) -> dict[str, tuple[int, ...]]:
    """The JAX leaf shapes of an ``_SNBase`` layer's tensors (weight
    trailing axis = output features)."""
    from xmc_gan_tpu_torch.ops.grouped import GroupedDense
    from xmc_gan_tpu_torch.ops.modules import SNConv

    w = tuple(layer.weight.shape)
    if isinstance(layer, GroupedDense):
        g, f = layer.groups, layer.features
        shapes = {"weight": (g, w[1], f), "bias": (g, f)}
    elif isinstance(layer, SNConv):
        shapes = {"weight": (w[2], w[3], w[1], w[0]), "bias": (w[0],)}
    else:
        shapes = {"weight": (w[1], w[0]), "bias": (w[0],)}
    shapes["weight_u"] = (w[0],)
    shapes["weight_v"] = (math.prod(w[1:]),)
    return shapes


def _rule(shape: tuple[int, ...], tp: int, tp_min_size: int) -> bool:
    """The JAX package's ``state_shardings`` test for one leaf."""
    return (tp > 1 and len(shape) >= 1 and math.prod(shape) >= tp_min_size
            and shape[-1] % tp == 0)


def _module_shardings(model: nn.Module, tp: int, tp_min_size: int) -> dict[str, Any]:
    from xmc_gan_tpu_torch.ops.grouped import GroupedDense
    from xmc_gan_tpu_torch.ops.modules import _SNBase

    out: dict[str, Any] = {}
    for prefix, mod in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        shapes = _jax_shapes(mod) if isinstance(mod, _SNBase) else {}
        outer = mod.groups if isinstance(mod, GroupedDense) else 1
        for name, t in [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]:
            shape = shapes.get(name, tuple(t.shape))
            if not _rule(shape, tp, tp_min_size):
                out[pre + name] = None
            elif name == "weight" and shapes:
                out[pre + name] = RowShard(tp, outer)
            else:  # a bias, a vector or another 1-D leaf split on its only axis
                out[pre + name] = RowShard(tp, outer if name == "bias" else 1)
    return out


def state_shardings(mesh: Mesh | int, state: Any, tp_min_size: int = 1 << 16) -> dict:
    """The JAX package's ``state_shardings`` on the port's tensors: for a
    module, ``{state_dict name: RowShard or None}`` (None = replicated); for
    a ``train.TrainState``, ``{"g": ..., "d": ...}`` (its Adam moments
    follow their parameters, its step is replicated).  ``mesh`` is a
    ``Mesh`` or its ``tp``."""
    tp = mesh if isinstance(mesh, int) else mesh.tp
    if isinstance(state, nn.Module):
        return _module_shardings(state, tp, tp_min_size)
    return {"g": _module_shardings(state.g, tp, tp_min_size),
            "d": _module_shardings(state.d, tp, tp_min_size)}


# ------------------------------------------------------------------- seam


class ColumnShard:
    """This model rank's output rows of one ``_SNBase`` layer (its
    ``shard``): the layer's ``weight`` holds them, the bias and the spectral
    vectors stay whole."""

    def __init__(self, mesh: Mesh, rows: RowShard, layer: nn.Module):
        from xmc_gan_tpu_torch.ops.modules import SNConv

        self.mesh, self.rows = mesh, rows
        self.groups = getattr(layer, "groups", 1)
        self.in_slice = None
        self.gather_weight = False
        if isinstance(layer, SNConv) and layer.groups > 1:
            per_group = layer.weight.shape[0] // layer.groups
            local = layer.weight.shape[0] // mesh.tp
            if local % per_group:  # a part of a group: the whole output
                self.gather_weight = True
            else:  # whole groups: this rank's groups and their input channels
                self.groups = layer.groups // mesh.tp
                n_in = layer.weight.shape[1] * self.groups
                self.in_slice = (mesh.model_rank * n_in, n_in)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        return self.rows.take(t, self.mesh.model_rank)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's rows (no gradient)."""
        return _gathered(t, self.mesh, 0, self.rows.outer)

    def __call__(self, layer: nn.Module, x: torch.Tensor, op: Callable, dim: int) -> torch.Tensor:
        """``op(x, weight, bias, groups)`` of the whole layer, this rank
        computing its rows: ``dim`` is the output's feature axis."""
        from xmc_gan_tpu_torch.ops.modules import _spectral_normalize

        mesh = self.mesh
        b = None if layer.bias is None else layer.bias.to(x.dtype)
        if self.gather_weight:
            w = gather_from_model(layer.weight, mesh, 0, self.rows.outer)
            if layer.spec_norm:
                w = _spectral_normalize(w, layer.weight_u, layer.weight_v)
            return op(x, w, b, layer.groups)
        x = copy_to_model(x, mesh)
        if self.in_slice is not None:
            x = x.narrow(1, *self.in_slice)
        w = layer.weight
        if layer.spec_norm:
            w32 = w.float()
            part = self.take(layer.weight_u) @ (w32.reshape(w32.shape[0], -1) @ layer.weight_v)
            w = (w32 / reduce_over_model(part, mesh)).to(w.dtype)
        y = gather_from_model(op(x, w, None, self.groups), mesh, dim, self.rows.outer)
        if b is not None:
            shape = [1] * y.dim()
            shape[dim] = -1
            y = y + b.view(shape)
        return y


@torch.no_grad()
def refresh_sharded_spectral(layer: nn.Module, iters: int) -> None:
    """``train.refresh_spectral`` for a layer whose rows are split: ``v =
    normalize(sum_r W_r^T u_r)``, ``u = normalize(gather(W_r v))`` on the
    ``(out, -1)`` matricization; the vectors stay whole on every rank."""
    shard: ColumnShard = layer.shard
    w = layer.weight.float()
    w = w.reshape(w.shape[0], -1)
    u, v = layer.weight_u, layer.weight_v
    for _ in range(iters):
        v = _summed(w.T @ shard.take(u), shard.mesh)
        v = v / v.norm().clamp_min(1e-12)
        u = shard.gather(w @ v)
        u = u / u.norm().clamp_min(1e-12)
    layer.weight_u.copy_(u)
    layer.weight_v.copy_(v)


# ---------------------------------------------------------- switching on


def _sharded_layers(model: nn.Module) -> dict[str, nn.Module]:
    return {name: m for name, m in model.named_modules()
            if getattr(m, "shard", None) is not None}


def sharded_tensors(model: nn.Module) -> set[int]:
    """``id``s of the model's parameters that hold a part (its split weights)."""
    return {id(m.weight) for m in _sharded_layers(model).values()}


_MOMENTS = ("exp_avg", "exp_avg_sq")


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh, optimizer: torch.optim.Optimizer | None = None,
                tp_min_size: int = 1 << 16) -> nn.Module:
    """Switch ``model`` to tensor parallelism over ``mesh``'s model group,
    in place: each layer whose weight ``state_shardings`` splits keeps this
    rank's rows (and ``optimizer``'s moments of them, where it has any) and
    computes them column-parallel.  Every rank of the model group must hold
    the same whole model first (``parallel.replicate``).  A split of any
    other tensor (a bias, a spectral vector, a norm's scale: none of the
    shipped configurations has one) raises ``NotImplementedError`` before
    anything changes."""
    from xmc_gan_tpu_torch.ops.modules import _SNBase

    if getattr(model, "tp_mesh", None) is not None:
        raise ValueError("the model is sharded already")
    specs = _module_shardings(model, mesh.tp, tp_min_size)
    layers = {name: m for name, m in model.named_modules() if isinstance(m, _SNBase)}
    weights = {(f"{n}." if n else "") + "weight" for n in layers}
    other = sorted(k for k, s in specs.items() if s is not None and k not in weights)
    if other:
        raise NotImplementedError(
            f"tensor parallelism splits only layer weights; tp={mesh.tp} at tp_min_size="
            f"{tp_min_size} would split {other} of {type(model).__name__}")
    for name, layer in layers.items():
        rows = specs[(f"{name}." if name else "") + "weight"]
        if rows is None:
            continue
        layer.shard = ColumnShard(mesh, rows, layer)
        p = layer.weight
        p.data = layer.shard.take(p.data).clone()
        state = optimizer.state.get(p, {}) if optimizer is not None else {}
        for key in _MOMENTS:
            if key in state:
                state[key] = layer.shard.take(state[key]).clone()
    model.tp_mesh = mesh
    return model


def shard_state(state, mesh: Mesh, tp_min_size: int = 1 << 16):
    """``shard_model`` for G and D of a ``train.TrainState`` and their Adam
    states."""
    shard_model(state.g, mesh, state.g_opt, tp_min_size)
    shard_model(state.d, mesh, state.d_opt, tp_min_size)
    return state


def _param_index(model: nn.Module, opt: torch.optim.Optimizer) -> dict[int, ColumnShard]:
    """Optimizer ``state_dict`` index -> the shard of the weight it holds."""
    by_id = {id(m.weight): m.shard for m in _sharded_layers(model).values()}
    params = [p for group in opt.param_groups for p in group["params"]]
    return {i: by_id[id(p)] for i, p in enumerate(params) if id(p) in by_id}


@torch.no_grad()
def gather_state(state) -> dict:
    """The whole ``train.TrainState`` of a sharded one, on the CPU, in the
    format ``utils/checkpoint.py`` writes for one process: ``{"step", "g",
    "d", "g_opt", "d_opt"}``.  A collective: every rank of the model group
    must call it."""
    out: dict[str, Any] = {"step": int(state.step)}
    for key, net, opt in (("g", state.g, state.g_opt), ("d", state.d, state.d_opt)):
        layers = _sharded_layers(net)
        sd = net.state_dict()
        for name, m in layers.items():
            sd[f"{name}.weight"] = m.shard.gather(m.weight)
        out[key] = {k: v.cpu() for k, v in sd.items()}
        osd = opt.state_dict()  # its per-parameter dicts are the optimizer's own
        shards = _param_index(net, opt)
        out[f"{key}_opt"] = {
            "param_groups": osd["param_groups"],
            "state": {i: {k: (shards[i].gather(v) if i in shards and k in _MOMENTS else v).cpu()
                          if isinstance(v, torch.Tensor) else v for k, v in s.items()}
                      for i, s in osd["state"].items()}}
    return out


@torch.no_grad()
def load_state(state, payload: dict) -> None:
    """Load a whole train state (``gather_state``'s or a one-process
    checkpoint's) into a sharded ``state``, each rank taking its rows."""
    for key, net, opt in (("g", state.g, state.g_opt), ("d", state.d, state.d_opt)):
        sd = dict(payload[key])
        for name, m in _sharded_layers(net).items():
            sd[f"{name}.weight"] = m.shard.take(sd[f"{name}.weight"])
        net.load_state_dict(sd, strict=True)
        osd = payload[f"{key}_opt"]
        local = {"param_groups": osd["param_groups"],
                 "state": {i: dict(s) for i, s in osd["state"].items()}}
        for i, shard in _param_index(net, opt).items():
            for mk in _MOMENTS:
                if mk in local["state"].get(i, {}):
                    local["state"][i][mk] = shard.take(local["state"][i][mk])
        opt.load_state_dict(local)
    state.step = int(payload["step"])
