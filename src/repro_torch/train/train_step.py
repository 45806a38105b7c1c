"""Train-step builders per architecture family.

``make_train_step`` composes: loss → grads (:func:`value_and_grad`) →
(optional int8 error-feedback compression) → (AdamW | Adafactor) → new
state. The step runs eagerly (the reference's ``jax.jit`` and buffer
donation have no counterpart); a state is never changed in place, so the
step is a function of (state, batch).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import GNNConfig, LMConfig, RecSysConfig
from repro_torch.models import gnn, layers as L, recsys as R
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import (
    AdamW, Adafactor, ErrorFeedbackCompressor, tree_leaves, tree_map,
)

__all__ = [
    "TrainState",
    "lm_loss_fn",
    "gnn_full_loss_fn",
    "gnn_minibatch_loss_fn",
    "gnn_molecule_loss_fn",
    "recsys_loss_fn",
    "value_and_grad",
    "make_train_step",
    "default_optimizer",
]


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    comp_state: Any
    step: torch.Tensor


def default_optimizer(cfg) -> AdamW | Adafactor:
    """kimi-scale MoE trains with Adafactor (optimizer-state memory);
    everything else with AdamW."""
    if isinstance(cfg, LMConfig) and cfg.moe and cfg.params_dense > 1e11:
        return Adafactor(lr=1e-3)
    return AdamW(lr=3e-4)


# ------------------------------------------------------------ loss closures
def lm_loss_fn(cfg: LMConfig) -> Callable:
    def loss(params, batch):
        return T.train_loss(params, cfg, batch["tokens"])

    return loss


def gnn_full_loss_fn(cfg: GNNConfig) -> Callable:
    def loss(params, batch):
        logits = gnn.gcn_apply(
            params, cfg, batch["feats"], batch["src"], batch["dst"],
            batch["edge_w"], batch.get("mean_deg"),
        )
        l = gnn.node_xent(logits, batch["labels"], batch["label_mask"])
        return l, {"nll": l}

    return loss


def gnn_minibatch_loss_fn(cfg: GNNConfig) -> Callable:
    def loss(params, batch):
        logits = gnn.gcn_apply(
            params, cfg, batch["feats"], batch["src"], batch["dst"],
            batch["edge_w"],
        )
        l = gnn.node_xent(logits, batch["labels"], batch["seed_mask"])
        return l, {"nll": l}

    return loss


def gnn_molecule_loss_fn(cfg: GNNConfig) -> Callable:
    def loss(params, batch):
        logits = gnn.batched_graph_apply(
            params, cfg, batch["feats"], batch["src"], batch["dst"],
            batch["edge_w"],
        )
        l = gnn.graph_xent(logits, batch["labels"])
        return l, {"nll": l}

    return loss


def recsys_loss_fn(cfg: RecSysConfig) -> Callable:
    if cfg.model == "bert4rec":
        def loss(params, batch):
            l = R.bert4rec_masked_xent(params, cfg, batch)
            return l, {"nll": l}
        return loss

    score = {"fm": R.fm_score, "dlrm": R.dlrm_score,
             "dien": R.dien_score}[cfg.model]

    def loss(params, batch):
        logits = score(params, cfg, batch)
        l = R.bce_loss(logits, batch["label"])
        return l, {"nll": l}

    return loss


# --------------------------------------------------------------- train step
def value_and_grad(loss_fn: Callable, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)`` of the
    port: (loss, metrics, grads), the gradient a tree like ``params``
    (zeros for a leaf the loss does not reach), taken by autograd with
    respect to detached copies of the leaves (no data is copied)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _: next(grads), params)


def _split(x, microbatches: int, i: int):
    """Microbatch ``i`` of a batch entry (numpy or torch): axis 0 cut in
    ``microbatches`` equal pieces."""
    if x.shape[0] % microbatches:
        raise ValueError(f"batch of {x.shape[0]} does not split into "
                         f"{microbatches} microbatches")
    m = x.shape[0] // microbatches
    return x[i * m:(i + 1) * m]


def make_train_step(
    loss_fn: Callable,
    optimizer,
    compressor: Optional[ErrorFeedbackCompressor] = None,
    microbatches: int = 1,
):
    """Returns (init_fn(params) -> TrainState, step_fn(state, batch)).

    ``params`` is a model (a :class:`~repro_torch.models.layers.ParamTree`)
    or its nested dict; the state holds the nested dict.

    ``microbatches > 1``: gradient accumulation — the batch is split on
    axis 0, the microbatches' gradients summed in order and divided by
    their count, their losses and metrics averaged (the reference's
    ``lax.scan``), so live activations scale 1/microbatches at the price
    of one params-sized gradient buffer."""
    comp = compressor or ErrorFeedbackCompressor(enabled=False)

    def init_fn(params) -> TrainState:
        params = L.as_tree(params)
        first = tree_leaves(params)[0]
        return TrainState(
            params=params,
            opt_state=optimizer.init(params),
            comp_state=comp.init(params),
            step=torch.zeros((), dtype=torch.int32, device=first.device),
        )

    def _grads(params, batch):
        if microbatches == 1:
            return value_and_grad(loss_fn, params, batch)
        acc, losses, metrics = None, [], []
        for i in range(microbatches):
            mb = {k: _split(v, microbatches, i) for k, v in batch.items()}
            loss, m, g = value_and_grad(loss_fn, params, mb)
            acc = g if acc is None else tree_map(torch.add, acc, g)
            losses.append(loss)
            metrics.append(m)
        grads = tree_map(lambda g: g / torch.tensor(
            microbatches, dtype=g.dtype, device=g.device), acc)
        metrics = {k: torch.mean(torch.stack([m[k] for m in metrics]))
                   for k in metrics[0]}
        return torch.mean(torch.stack(losses)), metrics, grads

    def step_fn(state: TrainState, batch: Dict):
        loss, metrics, grads = _grads(state.params, batch)
        grads, comp_state = comp.apply(grads, state.comp_state)
        params, opt_state, opt_metrics = optimizer.update(
            grads, state.opt_state, state.params
        )
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return (
            TrainState(
                params=params,
                opt_state=opt_state,
                comp_state=comp_state,
                step=state.step + 1,
            ),
            metrics,
        )

    return init_fn, step_fn
