"""Optimizers of the port, written out (as the reference writes its own
rather than use optax): AdamW and Adafactor, global-norm clipping and the
int8 error-feedback gradient compression transform.

Parameters, gradients and optimizer states are nested dicts (and lists)
of tensors, the reference's pytrees; every ``update`` is functional (new
tensors out, its inputs untouched) and runs under ``torch.no_grad()``.

Adafactor (factored second moments for rank-≥2 leaves) is what the
kimi-k2-1t config trains with: full Adam on 1T params costs 8 bytes/param
of optimizer state (16 TB); factored moments cost ~2·√ of that per
matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.dist.collectives import dequantize_int8, quantize_int8

__all__ = ["AdamW", "Adafactor", "clip_by_global_norm",
           "ErrorFeedbackCompressor", "tree_map", "tree_leaves"]

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (nested dicts, lists and tuples; a dict's keys in ``tree``'s order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):  # a NamedTuple (TrainState)
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def _unzip(tree: PyTree, n: int) -> Tuple[PyTree, ...]:
    """A tree whose leaves are n-tuples -> n trees."""
    return tuple(_pick(tree, i) for i in range(n))


def _pick(tree: PyTree, i: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


@torch.no_grad()
def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    # multiply in each leaf's own dtype: an f32 scalar would upcast every
    # bf16 grad leaf (GB-scale f32 copies at kimi size)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0

    def init(self, params: PyTree) -> PyTree:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        first = tree_leaves(params)[0]
        return {
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device),
        }

    @torch.no_grad()
    def update(self, grads: PyTree, state: PyTree, params: PyTree):
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        step = state["step"] + 1
        bc1 = 1.0 - self.b1 ** step.float()
        bc2 = 1.0 - self.b2 ** step.float()

        def upd(p, g, m, v):
            g = g.float()
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            return (p.float() - self.lr * u).to(p.dtype), m, v

        new_p, new_m, new_v = _unzip(
            tree_map(upd, params, grads, state["m"], state["v"]), 3)
        return new_p, {"m": new_m, "v": new_v, "step": step}, {
            "grad_norm": gnorm}


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-3
    decay: float = 0.8          # \hat\beta_2t = 1 - t^{-decay}
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    max_grad_norm: float = 1.0

    def init(self, params: PyTree) -> PyTree:
        def leaf_state(p):
            if p.dim() >= 2:
                # factor over the two trailing dims; lead dims (layer
                # stacks, experts) stay explicit
                return {
                    "row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                       device=p.device),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=torch.float32, device=p.device),
                }
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}

        first = tree_leaves(params)[0]
        return {
            "second": tree_map(leaf_state, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device),
        }

    @torch.no_grad()
    def update(self, grads: PyTree, state: PyTree, params: PyTree):
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        step = state["step"] + 1
        beta2 = 1.0 - step.float() ** (-self.decay)
        eps1 = self.eps1

        def upd(p, g, s):
            # the big [*, d_in, d_out] tensors stay in the PARAM dtype; only
            # the factored statistics and reductions run in f32
            g2_row = torch.mean(torch.square(g.float()), dim=-1) + eps1
            if p.dim() >= 2:
                g2_col = torch.mean(torch.square(g.float()), dim=-2) + eps1
                row = beta2 * s["row"] + (1 - beta2) * g2_row
                col = beta2 * s["col"] + (1 - beta2) * g2_col
                rmean = torch.mean(row, dim=-1, keepdim=True)
                factor = torch.rsqrt(
                    (row / torch.clamp(rmean, min=eps1))[..., None]
                    * col[..., None, :] + eps1).to(p.dtype)
                u = g * factor
                new_s = {"row": row, "col": col}
            else:
                v = beta2 * s["v"] + (1 - beta2) * (
                    torch.square(g.float()) + eps1)
                u = (g.float() * torch.rsqrt(v + eps1)).to(p.dtype)
                new_s = {"v": v}
            # update clipping (Shazeer & Stern §6); reduction in f32
            rms_u = torch.sqrt(torch.mean(torch.square(u.float())) + eps1)
            damp = (1.0 / torch.clamp(rms_u / self.clip_threshold, min=1.0)
                    ).to(p.dtype)
            scale = torch.clamp(torch.sqrt(torch.mean(torch.square(
                p.float()))), min=self.eps2).to(p.dtype)
            return p - (self.lr * scale * damp).to(p.dtype) * u, new_s

        # each parameter leaf meets its state dict ({"row", "col"} or {"v"})
        new_p, new_second = _unzip(
            tree_map(upd, params, grads, state["second"]), 2)
        return new_p, {"second": new_second, "step": step}, {
            "grad_norm": gnorm}


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackCompressor:
    """int8 gradient compression with error feedback (1-bit-Adam-style).

    g_hat = dequant(quant(g + err)); err' = (g + err) − g_hat.
    The quantized representation is what crosses the wire in deployment
    (:func:`repro_torch.dist.collectives.compressed_psum` is the collective
    itself); error feedback makes the *sequence* of updates unbiased.
    """

    enabled: bool = True

    def init(self, params: PyTree) -> PyTree:
        if not self.enabled:
            return {}
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    @torch.no_grad()
    def apply(self, grads: PyTree, err: PyTree):
        if not self.enabled:
            return grads, err

        def one(g, e):
            corrected = g.float() + e
            q, scale = quantize_int8(corrected)
            g_hat = dequantize_int8(q, scale)
            return g_hat.to(g.dtype), corrected - g_hat

        return _unzip(tree_map(one, grads, err), 2)
