"""Step builders, in PyTorch: the port of ``repro/launch/steps.py``: the
train step (gradient accumulation over microbatches, then AdamW) and the
serving steps.

The reference jits these with explicit shardings; the port runs them
eagerly, on one device or, under a mesh (``launch/sharding.py``:
``axis_rules``), on DTensors placed by ``launch/specs.py``, where
``grad_shardings`` pins the gradients to the parameters' layout.  On the
card every kernel of the step is the port's or a library's matrix product:
attention's forward and backward are the hand-written K6
(``kernels/flash_attention``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.launch.serve import tree_flatten, tree_unflatten
from repro_torch.launch.sharding import redistribute
from repro_torch.launch.specs import tree_map2
from repro_torch.models.lm import Model
from repro_torch.optim import adamw


def microbatch_reshape(batch: Dict[str, Any], n: int) -> Dict[str, Any]:
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 1 and v.shape and v.shape[0] % n == 0:
            out[k] = v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
        else:
            out[k] = v
    return out


def loss_and_grads(model: Model, params, batch) -> Tuple[torch.Tensor, Any]:
    """(loss, gradient tree in the parameters' types) of
    ``model.train_loss``: one autograd pass.  The parameter leaves are
    marked to require grad (the step reads no other flag of theirs); a leaf
    the loss does not reach gets a zero gradient, as under ``jax.grad``."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        loss, _metrics = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(treedef, grads)


def accumulate(acc_leaves, grads) -> None:
    """Add a microbatch's gradients to the fp32 accumulator's leaves."""
    for a, x in zip(acc_leaves, adamw.tree_leaves(grads)):
        a.add_(x.float())


def make_train_step(model: Model, acfg: adamw.AdamWConfig,
                    n_micro: int = 1,
                    grad_transform: Optional[Callable] = None,
                    grad_shardings: Any = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    With n_micro > 1 the global batch is split along dim 0 and gradients
    are accumulated in fp32 over the microbatches, one autograd pass each.
    ``grad_transform`` hooks gradient compression.  ``grad_shardings`` (a
    tree of ``NamedSharding`` matching params) pins the gradients and the
    fp32 accumulator to the parameter layout, as the reference's
    ``_constrain`` does: each microbatch's gradients are redistributed to
    it before they are added (a reduce-scatter where the parameter is
    sharded); ``None`` leaves them as autograd gives them.  The update is
    in place (``optim/adamw.py``)."""

    def _constrain(tree):
        if grad_shardings is None:
            return tree
        return tree_map2(redistribute, tree, grad_shardings)

    def train_step(params, opt_state, batch):
        if n_micro <= 1:
            loss, grads = loss_and_grads(model, params, batch)
            grads = _constrain(grads)
        else:
            mb = microbatch_reshape(batch, n_micro)
            gacc = _constrain(adamw.tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params))
            acc_leaves = adamw.tree_leaves(gacc)
            lsum = None
            for i in range(n_micro):
                li, g = loss_and_grads(model, params,
                                       {k: v[i] for k, v in mb.items()})
                accumulate(acc_leaves, _constrain(g))
                lsum = li if lsum is None else lsum + li
            grads = adamw.tree_map(lambda g: g / n_micro, gacc)
            loss = lsum / n_micro
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, om = adamw.update(acfg, params, opt_state, grads)
        metrics = {"loss": loss, **om}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model) -> Callable:
    """prefill_step(params, batch): the model's prefill.  A port model
    holds its parameters: ``params`` is the model itself, or a tree in its
    serving layout (``Model.init_tree``, ``params_from_jax``), which is
    installed first (``Model.load_params``)."""
    def prefill_step(params, batch):
        if params is not model:
            model.load_params(params)
        return model.prefill(batch)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """decode_step(params, cache, batch); ``params`` as for
    ``make_prefill_step``."""
    def decode_step(params, cache, batch):
        if params is not model:
            model.load_params(params)
        return model.decode(cache, batch)
    return decode_step
