"""AdamW with cosine / constant schedules and global-norm clipping (the
port of ``repro.train.optimizer``), as functions over the parameter
tree, not ``torch.optim``: the arithmetic is JAX's, in its order.

* weight decay reaches matrices only (``p.ndim >= 2``), unless the
  caller passes its own ``decay`` tree (the trainer passes JAX's rule read
  on JAX's stacked layout: ``trainer.weight_decay_mask``);
* bias correction and both schedules compute in float32;
* the moments are kept in ``moment_dtype`` (``"bfloat16"`` halves their
  memory) and widened to the gradient's dtype to update;
* clipping scales every gradient by ``min(1, clip_norm / (norm + 1e-9))``;
* a parameter without a gradient (``None``: the embedding table of an
  ``embeds``-mode model) is updated with a zero gradient, as JAX's zero
  cotangent is, so weight decay still reaches it.

The update runs in place under ``torch.no_grad()``: the parameter and
moment tensors of the tree passed in are the ones returned.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (the
    parameter tree's containers), paired with the same leaves of
    ``rest``.  Dicts are walked in sorted key order, as JAX flattens
    them, so a tree restored from a checkpoint (keys sorted) has its
    leaves in the order of a fresh one and sums over them agree bit for
    bit."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = (tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree))
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Schedule:
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(warmup_steps, 1)
        prog = ((step - warmup_steps)
                / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)
    return fn


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # moment dtype: "bfloat16" halves optimizer memory
    moment_dtype: str = ""

    def init(self, params) -> AdamWState:
        dt = getattr(torch, self.moment_dtype) if self.moment_dtype else None

        def zeros(p):
            return tree_map(lambda a: torch.zeros_like(a, dtype=dt or a.dtype),
                            p)

        leaf = tree_leaves(params)[0]
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=leaf.device),
                          mu=zeros(params), nu=zeros(params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, decay=None):
        """One step: returns (params, state, {"lr", "grad_norm"}), the
        parameters and moments updated in place.  ``decay``: a tree of
        bools like ``params`` naming the leaves weight decay reaches
        (None: ``p.ndim >= 2``)."""
        if decay is None:
            decay = tree_map(lambda p: p.ndim >= 2, params)
        grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None
                         else g, grads, params)
        step = state.step + 1
        lr = self.schedule(step)

        if self.clip_norm > 0:
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in tree_leaves(grads)))
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        else:
            gnorm = torch.zeros((), device=step.device)

        b1, b2 = self.b1, self.b2
        tree_map(lambda m, g: m.copy_(b1 * m.to(g.dtype) + (1 - b1) * g),
                 state.mu, grads)
        tree_map(lambda v, g: v.copy_(b2 * v.to(g.dtype)
                                      + (1 - b2) * g * g),
                 state.nu, grads)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        def upd(p, m, v, decayed):
            mhat = m.to(p.dtype) / bc1
            vhat = v.to(p.dtype) / bc2
            u = mhat / (torch.sqrt(vhat) + self.eps)
            if decayed:  # decoupled weight decay
                u = u + self.weight_decay * p
            p.sub_(lr * u)

        tree_map(upd, params, state.mu, state.nu, decay)
        return params, AdamWState(step, state.mu, state.nu), {
            "lr": lr, "grad_norm": gnorm}
