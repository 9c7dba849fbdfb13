"""Train state + train step (CE loss, AdamW, remat, optional compression).

Counterpart of ``repro.training.train_step``.  Gradients come from
autograd.  The state's ``params`` is the ``Transformer`` itself (its
parameters are the f32 master weights); ``opt_state`` and ``err_fb`` are
flat dicts keyed by its dotted parameter names.  A step updates the
model's parameters and the moments in place and returns a new
``TrainState`` around them: the old state shares them, so snapshot it
(``models.convert.to_reference``) before stepping if it is needed
after.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.common import P, ModelConfig, not_ported
from . import optimizer as opt


@dataclasses.dataclass
class TrainState:
    params: Any          # the Transformer
    opt_state: Any       # {"m": {name: t}, "v": {name: t}, "step": int32}
    err_fb: Any          # error-feedback residuals (None unless compression)


def make_train_state(gen: torch.Generator, cfg: ModelConfig, lr=3e-4,
                     adam: opt.AdamWConfig | None = None) -> TrainState:
    """The model initialised from ``gen`` on ``gen``'s device, zero
    moments and, under compression, zero error feedback."""
    model = tf.init_params(gen, cfg)
    params = dict(model.named_parameters())
    adam = adam or opt.AdamWConfig(lr=lr)
    err = (opt.init_error_feedback(params)
           if adam.grad_compress != "none" else None)
    return TrainState(model, opt.init_opt_state(params), err)


def loss_fn(model, cfg: ModelConfig, batch):
    logits, aux = model(batch["inputs"], batch.get("frontend"))
    labels = batch["labels"]
    mask = batch["mask"]
    if logits.shape[1] != labels.shape[1]:       # vlm prefix tokens
        logits = logits[:, -labels.shape[1]:]
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    loss = nll.sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss, aux


def train_step_fn(cfg: ModelConfig, adam: opt.AdamWConfig | None = None,
                  comm=None, mesh=None):
    """``step(state, batch) -> (state, metrics)`` with metrics ``loss``,
    ``grad_norm``, ``lr`` and ``moe_drop`` (0-d tensors)."""
    if mesh is not None:
        raise not_ported("a train step on a mesh", "3c",
                         "gradients through the ring attention's and the "
                         "expert-parallel MoE's collectives")
    adam = adam or opt.AdamWConfig()

    def step(state: TrainState, batch):
        model = state.params
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, aux = loss_fn(model, cfg, batch)
        loss.backward()
        with torch.no_grad():
            grads = {}
            for n, p in params.items():
                grads[n] = torch.zeros_like(p) if p.grad is None else p.grad
                p.grad = None
            grads, new_err = opt.apply_compression(adam, grads, state.err_fb)
            # the model's parameters and the moments are updated in place
            new_opt, om = opt.adamw_update_(
                adam, {n: p.detach() for n, p in params.items()}, grads,
                state.opt_state)
        metrics = {"loss": loss.detach(), **om,
                   **{k: v.detach() for k, v in aux.items()}}
        return TrainState(model, new_opt, new_err), metrics

    return step


def state_specs(cfg: ModelConfig, mesh_shape: dict):
    """Partition-spec tree for the whole TrainState, as the reference's:
    the parameters' (``transformer.param_specs``) for the parameters and
    both moments, ``P()`` for the step.  ``models.convert.local_spec``
    gives a moment's spec from its dotted name."""
    pspec = tf.param_specs(cfg, mesh_shape)
    return TrainState(params=pspec,
                      opt_state={"m": pspec, "v": pspec, "step": P()},
                      err_fb=None)
