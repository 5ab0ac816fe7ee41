"""AdamW with cosine schedule, global-norm clipping, decoupled decay.

Port of `repro.optim.adamw`: the same config, schedule, clipping, decay
mask and update, as plain functions over a model's named leaves (a
`ParamTree`'s ``named_parameters()``, or a mapping of names to tensors;
the decay mask reads the last component of a dotted name).  The moments
are float32 tensors keyed by those names.  Where the JAX package returns
new parameters and moments, `adamw_update` writes both in place (a
full-width model's masters, m and v are 1.4 GB each at smollm-360m) and
returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import torch
from torch import nn

Leaves = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def named_leaves(params: Leaves) -> Dict[str, torch.Tensor]:
    """The leaves of a `ParamTree` (or any module) by dotted name, or a
    mapping's, as they are."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_at(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to `lr`, then cosine decay to `min_lr_frac` of it, in
    float32 as the JAX package computes it."""
    step = torch.as_tensor(step).float()
    warm = c.lr * torch.clamp((step + 1) / max(c.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1), 0, 1)
    cos = c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < c.warmup_steps, warm, c.lr * cos)


def init_opt_state(params: Leaves) -> Dict:
    leaves = named_leaves(params)
    dev = next(iter(leaves.values())).device

    def zeros():
        return {name: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                for name, p in leaves.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors: Union[Mapping[str, torch.Tensor],
                               Iterable[torch.Tensor]]) -> torch.Tensor:
    if isinstance(tensors, Mapping):
        tensors = tensors.values()
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tensors))


def _decay_mask(name: str) -> bool:
    """No decay for norms / biases / 1-d params."""
    return name.split(".")[-1] not in (
        "scale", "bias", "b_in", "b_out", "bq", "bk", "bv", "dt_bias",
        "lambda", "D")


def adamw_update(
    c: AdamWConfig, params: Leaves, grads: Mapping[str, torch.Tensor],
    opt_state: Dict, gnorm: Optional[torch.Tensor] = None,
) -> Tuple[Leaves, Dict, Dict[str, torch.Tensor]]:
    """One step: clip by the global norm, update the moments, step the
    parameters.  Writes the parameters and the moments in place; returns
    (params, opt_state with the step advanced, {"grad_norm" (before
    clipping), "lr"}).  `gnorm`, where given, is the global norm of the
    whole model's gradient, of which `grads` is a rank's share (blocks of
    sharded leaves, `train.trainer`)."""
    step = opt_state["step"]
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(c, step)
    b1, b2 = c.beta1, c.beta2
    t = (step + 1).float()
    bc1 = 1 - b1**t
    bc2 = 1 - b2**t
    with torch.no_grad():
        for name, p in named_leaves(params).items():
            g = grads[name].float() * scale
            m = opt_state["m"][name].mul_(b1).add_((1 - b1) * g)
            v = opt_state["v"][name].mul_(b2).add_((1 - b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + c.eps)
            if _decay_mask(name):
                delta = delta + c.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
