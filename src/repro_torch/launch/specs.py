"""Parameter / optimizer / cache / batch PartitionSpecs, in PyTorch: the
port of ``repro/launch/specs.py``.

Policy knobs (the same as the reference's):
  * tensor-parallel ('model' axis) on the conventional col/row dims,
  * FSDP-style 2D weight sharding over the data axis for big archs,
  * ZeRO-1 optimizer-state sharding over data,
  * KV caches: kv-heads on 'model' when divisible, else kv-seq on 'model'.

The trees are the port's: parameters in the stacked layout, training's
(``models/lm.py``: ``stack_layers``; ``meta_params`` gives it without
memory), where each leaf of ``layers``, ``enc_layers`` and ``dec_layers``
leads with the layer dim, which stays unsharded; caches as ``prefill``
returns them (``Model.cache_spec``).  Leaves are read for ``.shape`` only,
and a leaf's path names are the reference's (``_path_names``): dict keys,
and list and tuple positions as strings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import (Axis, PartitionSpec as P,
                                         mesh_sizes, resolve_spec)

# stacked pytree prefixes whose leading dim is the layer index
_STACKED = ("layers", "enc_layers", "dec_layers")

# leaf name -> logical axes of the *last* dims (leading dims -> None)
# NOTE: w_Bm/w_Cm (mamba2 B/C, state dim N=64) stay REPLICATED, as in the
# reference: column sharding them makes every SSD C.B^T product a
# [B,nc,Q,Q] fp32 all-reduce
_COL = ("wq", "wk", "wv", "w_uq", "w_ukv", "w_z", "w_x",
        "w_dt", "cm_wk", "wr", "wg", "cm_wr")
_ROW = ("wo", "w_out", "cm_wv")
_VEC_TP = ("bq", "bk", "bv", "conv_bx", "A_log", "D_skip", "dt_bias", "norm")
_CONV_TP = ("conv_x",)


@dataclass(frozen=True)
class ShardingPolicy:
    fsdp_params: bool = False       # 2D weight sharding over data axis
    fsdp_min_dim: int = 1024        # only fsdp-shard dims at least this big
    zero1: bool = True              # shard optimizer moments over data
    tp_seq_for_oddheads: bool = False  # seq-shard attention acts
    # expert-weight scheme: "ep_model" shards E over the model axis (default;
    # train-friendly), "ep_data_tp_ffn" shards E over data and the expert FFN
    # hidden over model: weights stay RESIDENT at serve time (no per-step
    # fsdp all-gather); tokens move to the experts instead
    expert_scheme: str = "ep_model"


def policy_for(cfg: ModelConfig, kind: str) -> ShardingPolicy:
    from repro_torch.configs.base import count_params
    big = count_params(cfg) * 2 > 12 * 2 ** 30 * 16   # > ~12GB/chip at TP16
    if kind == "train":
        return ShardingPolicy(fsdp_params=True, zero1=True)
    # serving: big MoE archs keep expert weights RESIDENT (E over data, FFN
    # hidden over model) instead of re-gathering fsdp shards every step
    scheme = "ep_data_tp_ffn" if (big and cfg.moe) else "ep_model"
    return ShardingPolicy(fsdp_params=big, zero1=False,
                          expert_scheme=scheme)


def _effective_dims(path: Tuple[str, ...], shape: Tuple[int, ...]
                    ) -> Tuple[int, Tuple[int, ...]]:
    """Number of leading stacked dims to skip, remaining shape."""
    skip = 1 if path and path[0] in _STACKED else 0
    return skip, shape[skip:]


def _path_names(path) -> Tuple[str, ...]:
    """A leaf's path as the reference's names: keys and positions as
    strings."""
    return tuple(str(k) for k in path)


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) or isinstance(x, P)


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return type(tree)(tree_map_with_path(fn, v, path + (i,))
                      for i, v in enumerate(tree))


def tree_map2(fn: Callable, a: Any, b: Any) -> Any:
    """``fn(x, y)`` over the leaves of two trees of one structure, ``a``'s
    leaves PartitionSpecs or tensors."""
    if _is_leaf(a):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: tree_map2(fn, v, b[k]) for k, v in a.items()}
    return type(a)(tree_map2(fn, x, y) for x, y in zip(a, b))


def param_logical(path: Tuple[str, ...], shape: Tuple[int, ...],
                  policy: ShardingPolicy) -> Tuple[Optional[str], ...]:
    """Logical axes for one parameter (full rank, including stacked dims)."""
    name = path[-1]
    skip, dims = _effective_dims(path, shape)
    rank = len(dims)
    fsdp = "fsdp" if policy.fsdp_params else None

    def pad(spec: Sequence[Optional[str]]) -> Tuple[Optional[str], ...]:
        return (None,) * skip + tuple(spec)

    if name == "embed":
        return pad(("tp", fsdp))
    if name == "lm_head":
        return pad((fsdp, "tp"))
    if name in ("w_gate", "w_up"):
        if rank == 3:                       # MoE experts [E, D, F]
            if policy.expert_scheme == "ep_data_tp_ffn":
                return pad(("expert_fsdp", None, "tp"))
            return pad(("tp", fsdp, None))
        return pad((fsdp, "tp"))
    if name == "w_down":
        if rank == 3:                       # MoE experts [E, F, D]
            if policy.expert_scheme == "ep_data_tp_ffn":
                return pad(("expert_fsdp", "tp", None))
            return pad(("tp", None, fsdp))
        return pad(("tp", fsdp))
    if name in _COL:
        return pad((fsdp, "tp"))
    if name in _ROW:
        return pad(("tp", fsdp))
    if name in _VEC_TP and rank == 1:
        return pad(("tp",))
    if name in _CONV_TP:
        return pad((None, "tp"))
    if rank >= 2 and fsdp:
        # leftover matrices (MLA down-projections, routers, loras, frontend
        # projectors): FSDP-shard dim0 so their gradients reduce-scatter
        # instead of all-reducing at full size every microbatch
        return pad((fsdp,) + (None,) * (rank - 1))
    # norms, scalars, tiny vectors: replicated
    return pad((None,) * rank)


def _respect_min_dim(logical: Tuple[Optional[str], ...],
                     shape: Tuple[int, ...],
                     policy: ShardingPolicy) -> Tuple[Optional[str], ...]:
    out = []
    for name, dim in zip(logical, shape):
        if name == "fsdp" and dim < policy.fsdp_min_dim:
            out.append(None)
        else:
            out.append(name)
    return tuple(out)


def param_pspec_tree(params_shape: Any, mesh, rules: Dict[str, Axis],
                     policy: ShardingPolicy) -> Any:
    """Tree of PartitionSpec matching params (a tree of tensors: meta,
    real or DTensors)."""
    def f(path, leaf):
        names = _path_names(path)
        shape = tuple(leaf.shape)
        logical = param_logical(names, shape, policy)
        logical = _respect_min_dim(logical, shape, policy)
        return resolve_spec(logical, shape, mesh, rules)
    return tree_map_with_path(f, params_shape)


def opt_pspec_tree(params_shape: Any, mesh, rules: Dict[str, Axis],
                   policy: ShardingPolicy) -> Any:
    """ZeRO-1: moments get the param spec plus a data shard on the first
    still-unsharded divisible dim."""
    base = param_pspec_tree(params_shape, mesh, rules, policy)
    if not policy.zero1:
        return base
    data_axes = rules.get("opt_shard") or rules.get("batch")
    if data_axes is None:
        return base
    axes = (data_axes,) if isinstance(data_axes, str) else tuple(data_axes)
    sizes = mesh_sizes(mesh)
    size = 1
    for a in axes:
        size *= int(sizes[a])

    def f(spec, leaf):
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        used = set()
        for s in parts:
            if s is None:
                continue
            for a in ((s,) if isinstance(s, str) else s):
                used.add(a)
        if any(a in used for a in axes):
            return P(*parts)
        for i, (s, dim) in enumerate(zip(parts, leaf.shape)):
            if s is None and dim % size == 0 and dim >= size:
                parts[i] = axes[0] if len(axes) == 1 else tuple(axes)
                return P(*parts)
        return P(*parts)

    return tree_map2(f, base, params_shape)


# ----------------------------------------------------------------- batch/cache
_BATCH_LOGICAL = {
    "tokens": ("batch", "seq"),
    "targets": ("batch", "seq"),
    "loss_mask": ("batch", "seq"),
    "frames": ("batch", "seq", None),
    "frontend_embeds": ("batch", None, None),
    "pos": (),
}


def batch_pspec(specs: Dict[str, Any], mesh,
                rules: Dict[str, Axis]) -> Dict[str, P]:
    out = {}
    for k, v in specs.items():
        logical = _BATCH_LOGICAL.get(k, (None,) * len(v.shape))
        logical = tuple(logical[:len(v.shape)])
        out[k] = resolve_spec(logical, v.shape, mesh, rules)
    return out


def cache_logical(cfg: ModelConfig, leaf_path: Tuple[str, ...],
                  shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    """Logical axes for one cache leaf, by family and leaf name."""
    name = leaf_path[0] if leaf_path else ""
    rank = len(shape)
    if name == "pos":
        return ()
    if cfg.ssm and cfg.ssm.kind == "rwkv6":
        # [L,B,D] shifts / [L,B,H,N,N] wkv state
        if rank == 3:
            return (None, "batch", "ssm_inner")
        return (None, "batch", "heads", None, None)
    if cfg.ssm and cfg.ssm.kind == "mamba2":
        if name == "conv":                      # [L,B,K-1,conv_dim]
            return (None, "batch", None, "ssm_inner")
        if name == "ssd":                       # [L,B,H,N,P]
            return (None, "batch", "heads", None, None)
        if name == "x0_last":
            return ("batch", "embed")
        if name == "shared_kv":                 # [B,T,KV,hd] per invocation
            return ("batch", "kv_seq", "kv_heads", None)
    if cfg.mla:
        # ("kv",0): ckv [L,B,T,r]; ("kv",1): rope [L,B,T,rd]
        if rank == 4:
            return (None, "batch", "kv_seq", "kv_lora")
        if rank == 3:
            return ("batch", "kv_seq", "kv_lora")
    # dense KV caches: [L,B,T,KV,hd] (stacked) or [B,T,KV,hd] (prefix/shared)
    if rank == 5:
        return (None, "batch", "kv_seq", "kv_heads", None)
    if rank == 4:
        return ("batch", "kv_seq", "kv_heads", None)
    if rank == 2:
        return ("batch", None)
    return (None,) * rank


def cache_pspec_tree(cfg: ModelConfig, cache_shape: Any, mesh,
                     rules: Dict[str, Axis]) -> Any:
    def f(path, leaf):
        names = _path_names(path)
        logical = cache_logical(cfg, names, tuple(leaf.shape))
        return resolve_spec(logical, leaf.shape, mesh, rules)
    return tree_map_with_path(f, cache_shape)


def serving_rules(cfg: ModelConfig, rules: Dict[str, Axis],
                  mesh) -> Dict[str, Axis]:
    """Adjust logical rules for decode: prefer kv-head sharding when the head
    count divides the model axis, else shard the KV sequence."""
    r = dict(rules)
    r.setdefault("kv_lora", None)
    model = int(mesh_sizes(mesh).get("model", 1))
    if cfg.mla:
        # the latent cache is small a token, but 128 x 32k contexts still
        # need sequence sharding
        r["kv_seq"] = "model"
        r["kv_lora"] = None
    elif cfg.num_kv_heads % model == 0:
        r["kv_seq"] = None
    else:
        r["kv_seq"] = "model"
        r["kv_heads"] = None
    return r
