"""Fleet sharding over ``torch.distributed`` (port of ``repro.sharding``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    NamedSharding,
    PartitionSpec,
    agent_axis_names,
    agent_pspec,
    agent_shard_count,
    resolve_pspec,
    resolve_rules,
    gather_tree,
    shard_tree,
    tree_pspecs,
    tree_shardings,
)

_LAZY = ("make_sharded_train_step", "sketch_native_params",
         "gather_agents", "scatter_agents")


def __getattr__(name):
    # agent_shard imports repro_torch.core.api, which routes a mesh back
    # into agent_shard: resolve the step builder lazily, as JAX does
    if name in _LAZY:
        from repro_torch.sharding import agent_shard

        return getattr(agent_shard, name)
    raise AttributeError(name)
