"""Optimizers as pure functions over dicts of tensors (the JAX package's
``train/optim.py``).

An ``Optimizer`` is an ``(init, update)`` pair: ``init(params) ->
opt_state`` and ``update(grads, opt_state, params) -> (new_params,
new_opt_state)``, where params and grads are ``{name: tensor}`` and the
state is a nested dict of tensors (``()`` for plain SGD) with the JAX
package's slot names (``m``; ``count``/``mu``/``nu``; ``count``/
``inner`` under a schedule), so checkpoints carry across.  Updates
return new tensors; nothing is changed in place.

Adam is TensorFlow's formulation, as in the JAX package: ``lr_t = lr *
sqrt(1 - b2^t) / (1 - b1^t)`` with eps outside the bias correction —
not ``torch.optim.Adam``, whose eps sits inside it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensor leaves of nested dicts (same keys in every
    tree); other containers and leaves are passed to ``fn`` whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """Tensor leaves in the JAX package's flattening order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


def _decay(params, new_params, learning_rate: float, weight_decay: float):
    """Decoupled (AdamW-style) weight decay: ``lr * wd * p`` subtracted
    from the updated params, outside the gradient step."""
    if not weight_decay:
        return new_params
    return tree_map(lambda p, q: q - learning_rate * weight_decay * p,
                    params, new_params)


def clip_by_global_norm(grads, max_norm: float):
    """``(clipped_grads, global_norm)``: the whole gradient tree scaled by
    ``min(1, max_norm / ||g||)``."""
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in tree_leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def sgd(learning_rate: float, weight_decay: float = 0.0) -> Optimizer:
    """Plain SGD (the reference's ``GradientDescentOptimizer``)."""

    def init(params):
        return ()

    def update(grads, opt_state, params):
        new = tree_map(lambda p, g: p - learning_rate * g, params, grads)
        return _decay(params, new, learning_rate, weight_decay), opt_state

    return Optimizer("sgd", init, update)


def momentum(learning_rate: float, beta: float = 0.9,
             weight_decay: float = 0.0) -> Optimizer:
    """Heavy-ball momentum (``tf.train.MomentumOptimizer``)."""

    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    def update(grads, opt_state, params):
        m = tree_map(lambda m_, g: beta * m_ + g, opt_state["m"], grads)
        new = tree_map(lambda p, m_: p - learning_rate * m_, params, m)
        return _decay(params, new, learning_rate, weight_decay), {"m": m}

    return Optimizer("momentum", init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         moments_dtype=None) -> Optimizer:
    """TF's Adam.  ``moments_dtype`` (e.g. ``torch.bfloat16``) is the
    storage dtype of ``mu``/``nu``: the slots are cast up to f32 for the
    math, the fresh f32 moments drive the step, and only the store
    rounds."""

    def init(params):
        if moments_dtype is None:
            z = torch.zeros_like
        else:
            def z(p):
                return torch.zeros(p.shape, dtype=moments_dtype,
                                   device=p.device)
        dev = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": tree_map(z, params), "nu": tree_map(z, params)}

    def update(grads, opt_state, params):
        count = opt_state["count"] + 1
        t = count.to(torch.float32)
        if moments_dtype is None:
            def up(a):
                return a
        else:
            def up(a):
                return a.to(torch.float32)
        mu = tree_map(lambda m, g: b1 * up(m) + (1 - b1) * up(g),
                      opt_state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * up(v) + (1 - b2) * up(g) * up(g),
                      opt_state["nu"], grads)
        lr_t = learning_rate * torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        new = tree_map(lambda p, m, v: p - lr_t * m / (torch.sqrt(v) + eps),
                       params, mu, nu)
        if moments_dtype is not None:
            mu = tree_map(lambda m: m.to(moments_dtype), mu)
            nu = tree_map(lambda v: v.to(moments_dtype), nu)
        return (_decay(params, new, learning_rate, weight_decay),
                {"count": count, "mu": mu, "nu": nu})

    return Optimizer("adam", init, update)


def schedule_multiplier(schedule: str, warmup_steps: int, total_steps: int,
                        min_factor: float) -> Callable:
    """step (1-based, an f32 tensor) -> lr multiplier in [min_factor, 1]:
    linear warmup 0 -> 1 over ``warmup_steps``, then ``constant`` holds
    1 and ``cosine``/``linear`` decay to ``min_factor`` by
    ``total_steps``."""
    if schedule not in ("constant", "cosine", "linear"):
        raise ValueError(
            f"unknown lr_schedule {schedule!r}: expected constant, "
            f"cosine or linear")
    if schedule != "constant" and total_steps <= warmup_steps:
        raise ValueError(
            f"lr_schedule={schedule} needs total_steps ({total_steps}) > "
            f"warmup_steps ({warmup_steps}); pass --schedule_steps or "
            f"let the training loop derive it from the epoch count")

    def mult(t):
        warm = (torch.clamp(t, max=warmup_steps) / warmup_steps
                if warmup_steps > 0 else torch.ones_like(t))
        if schedule == "constant":
            return warm
        frac = torch.clamp((t - warmup_steps) / (total_steps - warmup_steps),
                           0.0, 1.0)
        if schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        else:
            decay = 1.0 - frac
        return warm * (min_factor + (1.0 - min_factor) * decay)

    return mult


def with_schedule(base: Optimizer, mult_fn: Callable) -> Optimizer:
    """``base`` with a per-step lr multiplier.  Every base update is
    linear in the learning rate, so scaling the param delta by the
    multiplier equals building the base with the scheduled lr; the
    slots stay schedule-independent."""

    def init(params):
        dev = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "inner": base.init(params)}

    def update(grads, opt_state, params):
        count = opt_state["count"] + 1
        s = mult_fn(count.to(torch.float32))
        newp, inner = base.update(grads, opt_state["inner"], params)
        newp = tree_map(lambda p, q: p + s * (q - p), params, newp)
        return newp, {"count": count, "inner": inner}

    return Optimizer(f"{base.name}+sched", init, update)


def make_optimizer(cfg, total_steps: int = 0) -> Optimizer:
    """The configured optimizer; a non-constant ``--lr_schedule`` decays
    over ``--schedule_steps`` or, if 0, ``total_steps``."""
    wd = cfg.weight_decay
    if cfg.optimizer == "sgd":
        base = sgd(cfg.learning_rate, wd)
    elif cfg.optimizer == "momentum":
        base = momentum(cfg.learning_rate, cfg.momentum, wd)
    elif cfg.optimizer == "adam":
        base = adam(cfg.learning_rate, cfg.adam_b1, cfg.adam_b2,
                    cfg.adam_eps, wd,
                    moments_dtype=(torch.bfloat16
                                   if cfg.adam_moments_dtype == "bfloat16"
                                   else None))
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.lr_schedule == "constant" and not cfg.warmup_steps:
        return base
    horizon = cfg.schedule_steps or total_steps
    return with_schedule(
        base, schedule_multiplier(cfg.lr_schedule, cfg.warmup_steps,
                                  horizon, cfg.lr_min_factor))
