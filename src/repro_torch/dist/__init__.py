"""repro_torch.dist — sharding rules, collectives, param specs, fault plans.

Model and serve code names *logical* axes; this package maps them onto
whatever mesh is active (none, a mesh of one device's positions, or one
position per card) with sharded implementations whose values equal their
single-device forms (tests/test_torch_mesh.py holds them against the JAX
package). It also holds the fault-tolerance plans (heartbeats, the elastic
remesh plan, and what replica loss does to privacy).
"""

from repro_torch.dist import collectives, fault, params, sharding
from repro_torch.dist.collectives import (
    all_gather,
    compressed_psum,
    dequantize_int8,
    psum_scatter,
    quantize_int8,
    sharded_record_lookup,
    sharded_table_lookup,
    sharded_vocab_lookup,
    xor_psum,
)
from repro_torch.dist.fault import (
    FleetState,
    HeartbeatMonitor,
    RemeshPlan,
    pir_degraded_privacy,
    plan_elastic_remesh,
    scheme_degradation,
)
# the function shadows the submodule attribute on purpose, as in the
# reference: `from repro_torch.dist import flash_decode` gives the callable
from repro_torch.dist.flash_decode import flash_decode
from repro_torch.dist.params import (
    generic_param_specs,
    lm_param_specs,
    tree_named_shardings,
)
from repro_torch.dist.sharding import (
    DEFAULT_RULES,
    MULTIPOD_RULES,
    Mesh,
    P,
    ShardedArray,
    axis_size,
    constrain,
    current_mesh,
    current_rules,
    device_put,
    logical_to_spec,
    make_mesh,
    mesh_axis_names,
    mesh_rules,
    touched_record_blocks,
)

__all__ = [
    "DEFAULT_RULES",
    "MULTIPOD_RULES",
    "FleetState",
    "HeartbeatMonitor",
    "Mesh",
    "P",
    "RemeshPlan",
    "ShardedArray",
    "all_gather",
    "axis_size",
    "collectives",
    "compressed_psum",
    "constrain",
    "current_mesh",
    "current_rules",
    "dequantize_int8",
    "device_put",
    "fault",
    "flash_decode",
    "generic_param_specs",
    "lm_param_specs",
    "logical_to_spec",
    "make_mesh",
    "mesh_axis_names",
    "mesh_rules",
    "params",
    "pir_degraded_privacy",
    "plan_elastic_remesh",
    "psum_scatter",
    "quantize_int8",
    "scheme_degradation",
    "sharded_record_lookup",
    "sharded_table_lookup",
    "sharded_vocab_lookup",
    "sharding",
    "touched_record_blocks",
    "tree_named_shardings",
    "xor_psum",
]
