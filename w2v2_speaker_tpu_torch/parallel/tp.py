"""Tensor parallelism over the mesh's ``model`` group, Megatron style.

Counterpart of ``w2v2_speaker_tpu/parallel/tp.py`` (:31-70). The JAX
package places the transformer's four large kernels with ``NamedSharding``
and lets GSPMD insert the all-reduces; here ``shard_model`` replaces them
in place by modules that hold this rank's shard and do the collectives
themselves:

- ``qkv_proj`` and ``intermediate_dense``: column-parallel (the output
  features split; the bias follows). The fused ``qkv_proj`` is split by
  heads within each of q, k and v, so a rank holds whole heads: its
  attention runs the hand-written kernels on its heads alone, with the
  dropout hash at their global head coordinates (``SelfAttention.head0``
  of ``total_heads``), and the activation dropout draws the global
  intermediate's columns (``HashDropout.cols``);
- ``out_proj`` and ``output_dense``: row-parallel (the input features
  split); the partial outputs are all-reduced over the model group before
  the replicated bias is added.

The input of a column-parallel layer goes through ``copy_to_model``
(identity forward, all-reduce backward) and the output of a row-parallel
one through ``reduce_from_model`` (all-reduce forward, identity backward),
so every replicated parameter gets the same gradient on every rank of a
model group, and the train step reduces all gradients over the data group
only. ``gather_state_dict``, ``gather_grads`` and ``gather_tree`` put the
shards back together (a checkpoint of the whole model). Only ``entry.dryrun_multichip``
uses this, as only ``__graft_entry__.dryrun_multichip`` uses the JAX rules.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh, _all_gather, _all_reduce_

__all__ = [
    "ColumnParallelLinear", "RowParallelLinear", "copy_to_model", "gather_grads", "gather_state_dict", "gather_tree",
    "reduce_from_model", "shard_model", "wav2vec2_tp_rules",
]

COLUMN, ROW, QKV = "column", "row", "qkv"


def wav2vec2_tp_rules() -> List[Tuple[str, str]]:
    """(name regex, placement) over the port's module names."""
    return [
        (r".*attention\.qkv_proj$", QKV),
        (r".*intermediate_dense$", COLUMN),
        (r".*attention\.out_proj$", ROW),
        (r".*output_dense$", ROW),
    ]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone().contiguous(), ctx.mesh, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_(x.detach().clone().contiguous(), mesh, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity; the backward all-reduces over the model group."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-reduce over the model group; the backward is the identity."""
    return _ReduceFromModel.apply(x, mesh)


class ColumnParallelLinear(nn.Module):
    """This rank's output features of a linear layer (``weight`` [out/tp,
    in], ``bias`` [out/tp])."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], mesh: Mesh, rule: str):
        super().__init__()
        self.mesh, self.rule = mesh, rule
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    @property
    def out_features(self) -> int:
        return self.weight.shape[0]

    def forward(self, x):
        return F.linear(copy_to_model(x, self.mesh), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """This rank's input features of a linear layer (``weight`` [out,
    in/tp]); the partial products are all-reduced, then the whole
    ``bias`` is added."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], mesh: Mesh):
        super().__init__()
        self.mesh, self.rule = mesh, ROW
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x):
        y = reduce_from_model(F.linear(x, self.weight), self.mesh)
        return y if self.bias is None else y + self.bias


def _qkv_rows(out_features: int, tp: int, rank: int) -> torch.Tensor:
    """This rank's rows of a fused [q; k; v] weight: its heads' block of
    each third."""
    h = out_features // 3
    block = h // tp
    return torch.cat([torch.arange(i * h + rank * block, i * h + (rank + 1) * block) for i in range(3)])


def _shard(full: torch.Tensor, rule: str, param: str, tp: int, rank: int) -> torch.Tensor:
    if rule == QKV:
        return full[_qkv_rows(full.shape[0], tp, rank)]
    if rule == COLUMN:
        return full.chunk(tp, dim=0)[rank]
    if param == "weight":  # row-parallel: the input features
        return full.chunk(tp, dim=1)[rank]
    return full  # a row-parallel bias is replicated


def _rule(name: str) -> Optional[str]:
    for pattern, rule in wav2vec2_tp_rules():
        if re.match(pattern, name):
            return rule
    return None


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace ``model``'s four large dense sites by their shards for this
    rank of the model group, in place (the full weights must be equal on
    every rank, as a seeded init or a loaded checkpoint makes them); each
    attention keeps its heads' block, each layer's activation dropout the
    global column coordinates. Returns ``model``."""
    tp, rank = mesh.model, mesh.model_rank
    if tp == 1:
        return model
    for name, module in list(model.named_modules()):
        rule = _rule(name)
        if rule is None or not isinstance(module, nn.Linear):
            continue
        parent_name, _, leaf = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        if rule == QKV and parent.num_heads % tp:
            raise ValueError(f"{parent.num_heads} heads not divisible by model={tp}")
        w = _shard(module.weight.detach(), rule, "weight", tp, rank).clone()
        b = None if module.bias is None else _shard(module.bias.detach(), rule, "bias", tp, rank).clone()
        setattr(parent, leaf, RowParallelLinear(w, b, mesh) if rule == ROW else ColumnParallelLinear(w, b, mesh, rule))
        if rule == QKV:
            parent.total_heads = parent.num_heads
            parent.num_heads //= tp
            parent.head0 = rank * parent.num_heads
        if leaf == "intermediate_dense":
            parent.act_dropout.cols = (rank * w.shape[0], w.shape[0] * tp)
    return model


def _gather(local: torch.Tensor, rule: str, param: str, mesh: Mesh) -> torch.Tensor:
    if rule == ROW and param == "bias":
        return local.detach().clone()
    parts = _all_gather(local.detach().unsqueeze(0), mesh, mesh.model, mesh.model_group)  # [tp, ...]
    if rule == QKV:  # [tp, 3 * block, in] -> q, k, v each in head order
        return torch.cat([torch.cat([p.chunk(3, dim=0)[i] for p in parts]) for i in range(3)])
    return torch.cat(list(parts), dim=1 if (rule == ROW and param == "weight") else 0)


def _placements(model: nn.Module) -> Dict[str, Tuple[str, str]]:
    """Parameter name -> (rule, weight or bias) of every sharded site."""
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, (ColumnParallelLinear, RowParallelLinear)):
            for param in ("weight", "bias"):
                if getattr(module, param) is not None:
                    out[f"{name}.{param}"] = (module.rule, param)
    return out


def _gather_named(named, model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    placed = _placements(model)
    return {name: (_gather(v, *placed[name], mesh) if name in placed else v.detach().clone()).cpu()
            for name, v in named}


@torch.no_grad()
def gather_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole model's ``state_dict`` (host tensors) from a sharded one;
    every rank of the model group must call it."""
    return _gather_named(model.state_dict().items(), model, mesh)


@torch.no_grad()
def gather_grads(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient (zeros for none) as the whole model's
    (host tensors), from a sharded model; every rank of the model group
    must call it."""
    return _gather_named(((n, torch.zeros_like(p) if p.grad is None else p.grad) for n, p in model.named_parameters()),
                         model, mesh)


@torch.no_grad()
def gather_tree(tree, model: nn.Module, mesh: Mesh):
    """``tree`` (a ``TrainState.state_dict()``) with every shard gathered:
    the model's entries, and in the optimizer's state the per-parameter
    tensors of a sharded parameter (``torch.optim`` states keyed by the
    parameter's index, or lists in parameter order)."""
    placed = _placements(model)
    names = [n for n, _ in model.named_parameters()]
    by_index = {i: placed.get(n) for i, n in enumerate(names)}
    shapes = [p.shape for p in model.parameters()]

    def at(i, x):
        if isinstance(x, torch.Tensor) and by_index.get(i) and x.shape == shapes[i]:
            return _gather(x, *by_index[i], mesh).cpu()
        return walk(x)

    def walk(x):
        if isinstance(x, dict):
            if x and all(isinstance(k, int) for k in x) and len(x) <= len(names):
                return {k: {kk: at(k, vv) for kk, vv in v.items()} if isinstance(v, dict) else at(k, v)
                        for k, v in x.items()}
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list) and len(x) == len(names) and all(isinstance(v, torch.Tensor) for v in x):
            return [at(i, v) for i, v in enumerate(x)]
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x.detach().clone().cpu() if isinstance(x, torch.Tensor) else x

    out = walk({k: v for k, v in tree.items() if k != "model"})
    out["model"] = gather_state_dict(model, mesh)
    return out
