"""repro_torch.comm — the composable communication-policy stack.

Public surface (the port of ``repro.comm``)::

    from repro_torch.comm import CommPolicy

    policy = CommPolicy.parse("gain_quadratic(lam=0.1,kernel=true)|int8+ef")
    str(policy)            # canonical spec string (round-trips)
"""
from repro_torch.comm.bank import StageBank, batch_prologue, build_stage_bank
from repro_torch.comm.compressors import (
    COMPRESSORS,
    Compressor,
    CompressorChain,
    WireFormat,
    build_compressor,
    chain_from_specs,
)
from repro_torch.comm.error_feedback import ef_add, ef_init, ef_residual
from repro_torch.comm.policy import (
    CommPolicy,
    ctrl_init,
    from_train_config,
    normalize_policy,
    resolve_policy,
    trigger_spec_from_config,
    with_kernel,
)
from repro_torch.comm.registry import Registry, StageSpec
from repro_torch.comm.rollup import CommRollup
from repro_torch.comm.spec import describe
from repro_torch.comm.stats import (
    CommStats,
    comm_stats,
    dense_bits,
    dense_entries,
    fold_sum,
    per_agent_wire_bytes,
    structural_bytes,
)
from repro_torch.comm.triggers import (
    CTRL_WIDTH,
    TRIGGERS,
    TriggerContext,
    TriggerFn,
    TriggerOutput,
    build_trigger,
    spec_is_adaptive,
)

__all__ = [
    "COMPRESSORS",
    "CTRL_WIDTH",
    "CommPolicy",
    "CommRollup",
    "CommStats",
    "Compressor",
    "CompressorChain",
    "Registry",
    "StageBank",
    "StageSpec",
    "TRIGGERS",
    "TriggerContext",
    "TriggerFn",
    "TriggerOutput",
    "WireFormat",
    "batch_prologue",
    "build_compressor",
    "build_stage_bank",
    "build_trigger",
    "chain_from_specs",
    "comm_stats",
    "ctrl_init",
    "dense_bits",
    "dense_entries",
    "describe",
    "ef_add",
    "ef_init",
    "ef_residual",
    "fold_sum",
    "from_train_config",
    "normalize_policy",
    "per_agent_wire_bytes",
    "resolve_policy",
    "spec_is_adaptive",
    "structural_bytes",
    "trigger_spec_from_config",
    "with_kernel",
]
