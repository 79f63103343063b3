"""Device steps of the port (``runtime/executor.py``): training on one
device or sharded over ranks (``runtime/sharding.py``, from a plan by
``runtime/plan_bridge.py``), the dense-cache serving and prefill steps,
and the paged serving steps, each on one device or sharded over ranks."""
from .executor import (abstract_params, gather_params, init_serving_params,
                       init_train_state, make_paged_decode_step,
                       make_paged_prefill_step, make_prefill_step,
                       make_serve_step, make_sharded_loss, make_train_step,
                       shard_serving_params, shard_train_state)
from .plan_bridge import (pipeline_loss_from_plan, policy_from_plan,
                          schedule_program_from_plan)
from .sharding import (DecodeLayout, ShardContext, ShardPolicy, batch_axes,
                       batch_specs, decode_state_specs, leaf_spec, opt_specs,
                       paged_state_specs, param_specs)

__all__ = ["DecodeLayout", "ShardContext", "ShardPolicy", "abstract_params",
           "batch_axes", "batch_specs", "decode_state_specs",
           "gather_params", "init_serving_params", "init_train_state",
           "leaf_spec", "make_paged_decode_step", "make_paged_prefill_step",
           "make_prefill_step", "make_serve_step", "make_sharded_loss",
           "make_train_step", "opt_specs", "paged_state_specs",
           "param_specs", "pipeline_loss_from_plan", "policy_from_plan",
           "schedule_program_from_plan", "shard_serving_params",
           "shard_train_state"]
