"""Multi-site local SGD with an outer optimizer (the JAX package's
``parallel/local_sgd.py``, DiLoCo-style) over the ``('site', 'data')``
layout of the process group (``parallel/mesh.build_site_mesh``).

Each site is a synchronous data-parallel group of ``dp`` ranks.  A
**round** runs ``--inner_steps`` H steps of the ordinary synchronous
step body (``parallel/step.make_sync_step_body``; the gradients summed
over the site's data group only), then ONE outer sync crosses the sites:

- the f32 **pseudo-gradient** ``params_at_round_start - params_after_H``,
  under ``--outer_quant=int8`` first compressed with error feedback
  (``ops/quant.ef_compress_int8``: each site carries its own f32
  residual across rounds), averaged over the site group;
- the **outer optimizer** (SGD or PyTorch-convention Nesterov, f32
  momentum) steps the round-start params by it, so every site ends the
  round with the same params;
- the **inner optimizer slots** stay per site and never cross the site
  axis.

Rank r holds its own site's copy: the params, the inner slots and, under
int8, the residual (``Block(("site",))`` leaves of the checkpoint
layout, stacked ``[sites, ...]`` in the global checkpoint as JAX stacks
them), with the outer state and the step whole beside them.  The int8
transport is emulated as in JAX: the sites average the dequantized f32
values; the ~4x byte saving is the closed form of
``obs/flops.local_sgd_outer_quant_bytes_per_round``, not a property of
this collective.  The outer sync runs under the ``outer_sync`` profiler
scope and the compression under ``quant``, JAX's scope names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch
from torch.profiler import record_function

from ..ops import quant as quant_lib
from ..train.optim import tree_map
from ..train.state import TrainState
from . import mesh as mesh_lib
from . import step as step_lib

SITE_AXIS = mesh_lib.SITE_AXIS

# valid --outer_optimizer values ("sgd" is nesterov with momentum
# pinned to 0: one code path, two names)
OUTER_OPTIMIZERS = ("sgd", "nesterov")


@dataclasses.dataclass(frozen=True)
class OuterOptimizer:
    """The outer (cross-site) optimizer: ``init(params) -> state`` and
    ``update(delta, state, params) -> (params, state)``, stepping the
    round-start ``params`` every site shares by the averaged f32
    pseudo-gradient ``delta``."""

    name: str
    lr: float
    momentum: float
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def make_outer_optimizer(name: str, lr: float,
                         momentum: float = 0.0) -> OuterOptimizer:
    """SGD or Nesterov momentum over pseudo-gradients (JAX's): ``m <-
    mu * m + delta``, applied step ``delta + mu * m``; at mu 0 the state
    is ``()`` and the step is ``delta``, so SGD at lr 1 is parameter
    averaging.  The momentum is f32 whatever the params' dtype, and the
    new params are computed in f32 and cast back."""
    if name not in OUTER_OPTIMIZERS:
        raise ValueError(
            f"outer_optimizer={name!r}: expected one of "
            f"{list(OUTER_OPTIMIZERS)}")
    mu = 0.0 if name == "sgd" else float(momentum)
    lr = float(lr)

    def init(params):
        if mu == 0.0:
            return ()
        return {"m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()}}

    def update(delta, state, params):
        if mu == 0.0:
            step_tree, new_state = delta, state
        else:
            m = tree_map(lambda m_, d: mu * m_ + d, state["m"], delta)
            step_tree = tree_map(lambda d, m_: d + mu * m_, delta, m)
            new_state = {"m": m}
        new_params = {k: (p - lr * step_tree[k]).to(p.dtype)
                      for k, p in params.items()}
        return new_params, new_state

    return OuterOptimizer(name, lr, mu, init, update)


def outer_optimizer_from_config(cfg) -> OuterOptimizer:
    return make_outer_optimizer(cfg.outer_optimizer, cfg.outer_lr,
                                cfg.outer_momentum)


def site_state(state: TrainState, outer: OuterOptimizer,
               outer_quant: str = "") -> TrainState:
    """A fresh state laid out for multi-site training, on this rank: the
    site's copy of the params, the inner optimizer slots under
    ``opt_state["inner"]``, the outer state under ``["outer"]`` and,
    under ``outer_quant="int8"``, the site's f32 error-feedback residual
    (zeros) under ``["ef"]``: JAX's ``site_state`` tree without the
    leading ``[sites]`` axis, which the checkpoint layout adds."""
    opt_state = {"inner": state.opt_state,
                 "outer": outer.init(state.params)}
    if outer_quant:
        if outer_quant != "int8":
            raise ValueError(f"outer_quant={outer_quant!r}: expected "
                             f"'' or 'int8'")
        opt_state["ef"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for k, p in state.params.items()}
    return TrainState(state.step, state.params, opt_state)


def site_block(key: str, leaf):
    """The checkpoint ``Block`` of a site-state leaf (JAX's
    ``site_specs``): the params, the inner slots and the residual vary
    over 'site' (``[sites, ...]`` globally); the outer state and the
    step are whole."""
    from ..utils.checkpoint import Block

    if key.startswith((".params/", ".opt_state/inner/", ".opt_state/ef/")):
        return Block((SITE_AXIS,))
    return None


def _site_mean_tree(tree: dict, mesh) -> dict:
    """Every leaf averaged over the site group, as one all-reduce of the
    leaves concatenated (the sum, then / sites, per element: JAX's
    ``pmean``)."""
    names = list(tree)
    flat = torch.cat([tree[k].reshape(-1) for k in names])
    flat = mesh_lib.site_mean(flat, mesh)
    out, off = {}, 0
    for k in names:
        n = tree[k].numel()
        out[k] = flat[off: off + n].view(tree[k].shape)
        off += n
    return out


def build_local_sgd_step(cfg, mesh, spec, optimizer,
                         outer: OuterOptimizer) -> Callable:
    """One multi-site round: ``(state, x, y) -> (state, cost, acc)`` on
    this rank's rows ``x``/``y`` of the round's global batch (its
    ``('site', 'data')`` shard).  The rows split into ``inner_steps``
    equal chunks, each one inner step of the synchronous body over the
    site's data group; then the pseudo-gradient, its int8 compression
    under ``--outer_quant``, its mean over the site group and the outer
    step.  The cost and accuracy are the last inner step's, averaged
    over the site group; ``state.step`` advances by H."""
    if mesh.sites < 2:
        raise ValueError("build_local_sgd_step needs a ('site','data') "
                         "mesh (mesh_lib.build_site_mesh)")
    if mesh.mp != 1:
        raise ValueError("multi-site local SGD composes with data "
                         "parallelism inside each site only "
                         "(model_parallel=1)")
    H = int(cfg.inner_steps)
    inner_body = step_lib.make_sync_step_body(cfg, spec, optimizer,
                                              mesh=mesh)
    quantize = getattr(cfg, "outer_quant", "") == "int8"

    def round_step(state: TrainState, x, y):
        if x.shape[0] % H:
            raise ValueError(
                f"per-device batch {x.shape[0]} must divide into "
                f"inner_steps={H} chunks")
        params0 = state.params
        st = TrainState(state.step, params0, state.opt_state["inner"])
        for xc, yc in zip(x.chunk(H), y.chunk(H)):
            st, cost, acc = inner_body(st, xc, yc)
        # what this site's H steps moved the round-start weights by, in
        # f32 so small steps on low-precision params average exactly
        delta = {k: p0.to(torch.float32) - st.params[k].to(torch.float32)
                 for k, p0 in params0.items()}
        new_opt = {"inner": st.opt_state}
        if quantize:
            with record_function("quant"):
                pairs = {k: quant_lib.ef_compress_int8(
                    d, state.opt_state["ef"][k]) for k, d in delta.items()}
            delta = {k: p[0] for k, p in pairs.items()}
            new_opt["ef"] = {k: p[1] for k, p in pairs.items()}
        with record_function("outer_sync"):
            # the one parameter-sized collective crossing 'site'
            delta = _site_mean_tree(delta, mesh)
            new_params, new_opt["outer"] = outer.update(
                delta, state.opt_state["outer"], params0)
        stats = mesh_lib.site_mean(
            torch.stack([cost, acc.to(cost.dtype)]), mesh)
        return TrainState(st.step, new_params, new_opt), stats[0], stats[1]

    return round_step


def build_site_unstack_params(mesh) -> Callable:
    """``state -> the consensus params`` for eval, sampling and the
    portable checkpoints: the site-group mean of the rank's site copy
    (JAX's ``build_site_unstack_params``).  Every round ends with the
    outer update, so the sites already agree: the mean is a safety
    net, not a reconciliation."""
    def unstack(state: TrainState) -> dict:
        if mesh.site_group is None:
            return state.params
        return _site_mean_tree(state.params, mesh)

    return unstack


__all__ = ["SITE_AXIS", "OUTER_OPTIMIZERS", "OuterOptimizer",
           "make_outer_optimizer", "outer_optimizer_from_config",
           "site_state", "site_block", "build_local_sgd_step",
           "build_site_unstack_params"]
