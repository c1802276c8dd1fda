"""The device mesh of the port: ``repro.sharding``'s rules (``partition``,
``trees``) over ``torch.distributed`` meshes, the activation constraints of
the dry run (``context``), and the data-parallel dispatch of stage-2 calls
(``dispatch``)."""
from repro_torch.sharding.partition import (DEFAULT_RULES, FSDP_RULES, SP_RULES, MeshRules, P, PartitionSpec,
                                            activation_specs, batch_spec, dp_size, explain_arg_shardings,
                                            explain_reduce_specs, explain_shardings, explain_specs,
                                            logical_to_spec, mesh_axes, mesh_cache_key, param_specs,
                                            spec_for_batch_tree, to_placements)
from repro_torch.sharding.context import ActivationPolicy, activation_sharding, constrain, make_policy
from repro_torch.sharding.trees import cache_specs, to_shardings, train_state_specs

__all__ = [
    "ActivationPolicy", "activation_sharding", "constrain", "make_policy",
    "DEFAULT_RULES", "FSDP_RULES", "MeshRules", "P", "PartitionSpec", "SP_RULES", "activation_specs",
    "batch_spec", "cache_specs", "dp_size", "explain_arg_shardings", "explain_reduce_specs",
    "explain_shardings", "explain_specs", "logical_to_spec", "mesh_axes", "mesh_cache_key", "param_specs",
    "spec_for_batch_tree", "to_placements", "to_shardings", "train_state_specs",
]
