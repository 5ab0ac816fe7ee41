"""Train-step construction: loss -> grads -> AdamW.

Port of the single-process branch of `repro.train.trainer`
(trainer.py:56-67): value and grad of `models.model.loss_fn` (autograd
in place of `jax.value_and_grad`), then `optim.adamw.adamw_update`, with
the metrics merged.  Its rotor inter-pod branch (a `shard_map` over the
pod axis whose gradient reduction is `rotor_all_reduce`, trainer.py:69-
112) needs the `ParallelContext` through the model and sharded weights
(ROADMAP Queue 1 item 7b); the explicit data-parallel trainer over the
rotor collectives is `train.opera_dp`.  On one process the JAX package's
two trainers give the same update (tests/test_trainer_serve.py:49-73),
which is this one.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state


def make_train_step(cfg: ModelConfig, opt: AdamWConfig) -> Callable:
    """(state, batch) -> (state, metrics): one step on `state` =
    {"params": trainable ParamTree, "opt": optimizer state}, written in
    place; metrics {"loss", "aux", "total", "grad_norm", "lr"} are 0-d
    tensors on the parameters' device."""

    def train_step(state: Dict, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        params = state["params"]
        names, leaves = zip(*params.named_parameters())
        total, metrics = loss_fn(params, batch, cfg)
        # a leaf the loss does not reach gets a zero gradient, as jax.grad
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        _, new_opt, om = adamw_update(opt, params, dict(zip(names, grads)),
                                      state["opt"])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        return {"params": params, "opt": new_opt}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, params) -> Dict:
    return {"params": params, "opt": init_opt_state(params)}
