"""Tensor parallelism of the wide heads (port of facodec_tpu/parallel/sharding.py).

The JAX package shards the genuinely wide parameters over its mesh's
`model` axis and lets the SPMD partitioner insert the collectives; every
other parameter stays replicated. The port keeps the rule and writes the
collectives out, as Megatron's column-parallel linear does:

- `tp_param_names(named_params, n_model)` is `tp_param_shardings`'s rule on
  the port's parameter names: a 2-D `weight` with at least `min_elems`
  elements and an output dim that `n_model` divides is split by output
  rows, and so is a 1-D `bias` of at least 4096 elements that it divides.
  At `config.FLAGSHIP_TRAIN` that is the speaker head and its adversary
  (20000 x 1024, with their biases), the two phone heads (1024 x 1024, their
  1024-wide biases replicated) and the quantizer's `timbre_linear`
  (2048 x 1024).
- `ColumnParallelLinear` holds its rank's rows of such a `Linear` under the
  same parameter names: forward, the local product, then an all-gather of
  the output over the model group (a replicated bias is added after it);
  backward, the output gradient's local columns, with no communication,
  and a sum over the model group of the input's gradient. The gathered
  output is what one process computes, so the losses downstream (the
  cross-entropies, the focal loss's `global_mean`) see the whole logits.
  Where the rule splits a bias but not its weight (a weight under
  `min_elems`), the weight stays whole and the bias's rows are gathered
  before the product.
- `shard_training(models, optimizers, lay)` swaps those modules in on every
  rank after the whole weights were seeded, loaded and broadcast, and cuts
  each AdamW's parameters and moments to the same rows.
- `whole_state_dict` / `whole_optimizer_state` gather the shards back over
  the model group (every rank calls them): a checkpoint holds whole
  tensors, so a checkpoint of a tensor-parallel run loads into one process
  and back, as the JAX package's global arrays do.
- `describe_shardings` names the sharded parameters for the log.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Set, Tuple

import torch
import torch.nn as nn

from facodec_tpu_torch.nn.basic import linear
from facodec_tpu_torch.parallel.mesh import Layout, gather_model, is_sharded, model_sum_

MIN_ELEMS = 1 << 20
MIN_BIAS = 4096


def tp_param_names(named_params: Iterable[Tuple[str, torch.Tensor]], n_model: int,
                   min_elems: int = MIN_ELEMS) -> Set[str]:
    """The names that `tp_param_shardings` splits by rows over a model axis
    of `n_model`; none for an axis of 1."""
    if n_model <= 1:
        return set()
    out = set()
    for name, p in named_params:
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.ndim == 2 and p.numel() >= min_elems \
                and p.shape[0] % n_model == 0:
            out.add(name)
        elif leaf == "bias" and p.ndim == 1 and p.shape[0] >= MIN_BIAS \
                and p.shape[0] % n_model == 0:
            out.add(name)
    return out


def rows_of(t: torch.Tensor, lay: Layout) -> torch.Tensor:
    """This model rank's contiguous rows of a whole tensor (a copy)."""
    n = t.shape[0] // lay.n_model
    return t[lay.model_rank * n:(lay.model_rank + 1) * n].clone()


def _mark(p: torch.Tensor, lay: Layout) -> nn.Parameter:
    param = nn.Parameter(p)
    param.tp_shard = (lay.model_rank, lay.n_model)
    return param


class _ToModel(torch.autograd.Function):
    """Identity forward; the input gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum_(g.contiguous().clone())


class _GatherLast(torch.autograd.Function):
    """The model group's outputs concatenated along the last dim; backward,
    this rank's columns of the (replicated) output gradient."""

    @staticmethod
    def forward(ctx, y, rank: int):
        ctx.rank, ctx.cols = rank, y.shape[-1]
        return gather_model(y, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.cols, ctx.cols).contiguous(), None


class ColumnParallelLinear(nn.Module):
    """A `Linear` whose output rows are split over the model group: holds
    this rank's rows of `weight` where `shard_weight` (else the whole
    weight) and of `bias` where `shard_bias` (else the whole bias), under
    the names the `Linear` had; returns the whole output on every rank of
    the group. Its products are `nn.basic.linear`, as `nn.basic.Linear`'s are."""

    def __init__(self, linear: nn.Linear, lay: Layout, shard_weight: bool, shard_bias: bool):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.model_rank = lay.model_rank
        self.shard_weight = shard_weight
        self.shard_bias = shard_bias and linear.bias is not None
        with torch.no_grad():
            w = linear.weight.detach()
            self.weight = _mark(rows_of(w, lay), lay) if shard_weight else nn.Parameter(w.clone())
            if linear.bias is None:
                self.bias = None
            elif self.shard_bias:
                self.bias = _mark(rows_of(linear.bias.detach(), lay), lay)
            else:
                self.bias = nn.Parameter(linear.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.shard_weight:  # the bias alone is split
            return linear(x, self.weight, _GatherLast.apply(self.bias, self.model_rank))
        y = linear(_ToModel.apply(x), self.weight, self.bias if self.shard_bias else None)
        y = _GatherLast.apply(y, self.model_rank)
        if self.bias is not None and not self.shard_bias:
            y = y + self.bias
        return y


def _owner(name: str) -> Tuple[str, str]:
    owner, _, leaf = name.rpartition(".")
    return owner, leaf


def shard_module(module: nn.Module, lay: Layout, min_elems: int = MIN_ELEMS
                 ) -> Dict[str, nn.Parameter]:
    """Swap every `nn.Linear` of `module` with a parameter that the rule
    splits for a `ColumnParallelLinear` of its rows; returns {name: new
    parameter} of every parameter replaced (sharded or not). Raises where
    the rule splits a parameter of another kind of module."""
    names = tp_param_names(module.named_parameters(), lay.n_model, min_elems)
    owners = {}
    for name in sorted(names):
        owner, leaf = _owner(name)
        sub = module.get_submodule(owner)
        if not isinstance(sub, nn.Linear):
            raise NotImplementedError(f"tensor parallelism: {name} ({type(sub).__name__}) "
                                      "would be split, and only a Linear's rows are")
        owners.setdefault(owner, set()).add(leaf)
    replaced = {}
    for owner, leaves in owners.items():
        linear = module.get_submodule(owner)
        new = ColumnParallelLinear(linear, lay, "weight" in leaves, "bias" in leaves)
        parent, _, attr = owner.rpartition(".")
        setattr(module.get_submodule(parent) if parent else module, attr, new)
        replaced[f"{owner}.weight"] = new.weight
        if new.bias is not None:
            replaced[f"{owner}.bias"] = new.bias
    return replaced


def shard_training(models: Mapping[str, nn.Module], optimizers: Mapping, lay: Optional[Layout],
                   min_elems: int = MIN_ELEMS) -> Dict[str, str]:
    """Shard every module's wide heads over the model group and point each
    module's AdamW at the new parameters, its moments cut to the same rows;
    returns `describe_shardings` of what was split. Nothing without a
    layout."""
    if lay is None:
        return {}
    for key, module in models.items():
        replaced = shard_module(module, lay, min_elems)
        opt = optimizers.get(key)
        if opt is None or not replaced:
            continue
        for i, name in enumerate(opt.names):
            if name in replaced:
                new = replaced[name]
                if is_sharded(new):
                    opt.mu[i], opt.nu[i] = rows_of(opt.mu[i], lay), rows_of(opt.nu[i], lay)
                opt.params[i] = new
    return describe_shardings(models)


def describe_shardings(models: Mapping[str, nn.Module]) -> Dict[str, str]:
    """{module.name: "rows r of n, local shape"} of the sharded parameters."""
    out = {}
    for key, module in models.items():
        for name, p in module.named_parameters():
            if is_sharded(p):
                rank, n = p.tp_shard
                out[f"{key}.{name}"] = f"rows {rank} of {n}, local {tuple(p.shape)}"
    return out


def _whole(t: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    return gather_model(t.detach(), dim=0) if is_sharded(param) else t


def whole_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with every shard gathered whole over the model
    group (a collective: every rank calls it)."""
    params = dict(module.named_parameters())
    return {k: _whole(v, params[k]) if k in params else v
            for k, v in module.state_dict().items()}


def whole_optimizer_state(opt) -> Dict:
    """An AdamW's `state_dict()` with its sharded moments gathered whole
    (every rank calls it)."""
    state = opt.state_dict()
    for key in ("mu", "nu"):
        state[key] = {name: _whole(t, p)
                      for (name, t), p in zip(state[key].items(), opt.params)}
    return state
