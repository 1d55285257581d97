"""AdamW with a bf16-moment option, global-norm clipping and a cosine
schedule, in PyTorch: the port of ``repro/optim/adamw.py``.

Functional in form, ``state = init(cfg, params)`` and ``params, state,
metrics = update(cfg, params, state, grads)``, over trees of tensors (dicts,
lists, tuples).  The math is the reference's, in fp32 whatever the leaves'
types: the clipped gradient is rounded back to its own type, the moments
are kept in ``moment_dtype``, weight decay applies to leaves of two or more
dimensions only, and each new parameter is cast back to its own type.
Unlike the reference, which donates its buffers to the jitted step,
``update`` writes the new parameters and moments into the tensors it is
given (to keep one copy of the training state on the card) and returns
those same trees; a caller that compares states across a step clones them
first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    mu: Any                  # tree like params
    nu: Any                  # tree like params


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"      # "float32" | "bfloat16"


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves in ``jax.tree.leaves``' order: dict keys sorted, lists
    and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` over the leaves, keeping the tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = cfg.lr_peak * step / max(1, cfg.warmup_steps)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) \
        * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), gn


def init(cfg: AdamWConfig, params) -> AdamWState:
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@torch.no_grad()
def update(cfg: AdamWConfig, params, state: AdamWState, grads,
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place (module docstring)."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(grads)):
        g32 = g.float()
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        del g32
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        # decoupled weight decay (skip 0/1-d params: norms, biases, scalars)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m32)
        v.copy_(v32)
    metrics = {"grad_norm": gn, "lr": lr}
    return params, AdamWState(step, state.mu, state.nu), metrics
