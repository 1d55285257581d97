"""Elastic re-meshing, in PyTorch: the port of ``repro/runtime/elastic.py``.
Reshard a training state onto a different mesh.

When the device pool changes (node loss, pool grow), training resumes on a
new (data', model') mesh: the parameters' PartitionSpecs are derived again
by the same rules (``launch/specs.py``) and each leaf is placed on the new
mesh (``distribute_tensor`` for a plain tensor, ``redistribute`` for a
DTensor of that mesh) — the spec logic does not care about the mesh's
shape, so elasticity is a relaunch concern only.  The default rules are
the launcher's, less the axes the new mesh lacks.  A DTensor of another
mesh is gathered whole first (``full_tensor``).
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.launch.sharding import (Axis, default_rules, mesh_sizes,
                                         on_mesh, placements)
from repro_torch.launch.specs import (ShardingPolicy, param_pspec_tree,
                                      tree_map2)


def reshard_params(params: Any, new_mesh, rules: Dict[str, Axis] = None,
                   policy: ShardingPolicy = None) -> Any:
    from torch.distributed.tensor import DTensor, distribute_tensor
    rules = rules or on_mesh(
        default_rules(multi_pod="pod" in mesh_sizes(new_mesh)), new_mesh)
    policy = policy or ShardingPolicy(fsdp_params=True)
    specs = param_pspec_tree(params, new_mesh, rules, policy)

    def place(spec, x):
        target = placements(spec, new_mesh)
        x = x.detach()
        if isinstance(x, DTensor):
            if x.device_mesh == new_mesh:
                return x.redistribute(new_mesh, target)
            x = x.full_tensor()
        return distribute_tensor(x, new_mesh, target)
    return tree_map2(place, specs, params)
