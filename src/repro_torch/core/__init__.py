"""Core: the declarative separable-chain API (spec -> plan -> lower ->
execute) and the whole-network engine (NetworkSpec -> NetworkPlan ->
execute_network), for the part of ``repro.core`` ported so far."""
from repro_torch.core.chain import (
    DW,
    PW,
    SeparableSpec,
    execute,
    init_chain,
    inverted_residual_spec,
    lower,
    plan,
    separable_block_spec,
)
from repro_torch.core.network import (
    NetworkModule,
    NetworkPlan,
    NetworkSpec,
    cast_network_params,
    execute_network,
    init_network,
    mobilenet_v1_spec,
    mobilenet_v2_spec,
    plan_network,
)
from repro_torch.kernels.policy import (
    BF16_STREAM,
    DEFAULT_POLICY,
    DtypePolicy,
    KernelPolicy,
)

__all__ = [
    "BF16_STREAM",
    "DEFAULT_POLICY",
    "DW",
    "DtypePolicy",
    "KernelPolicy",
    "NetworkModule",
    "NetworkPlan",
    "NetworkSpec",
    "PW",
    "SeparableSpec",
    "cast_network_params",
    "execute",
    "execute_network",
    "init_chain",
    "init_network",
    "inverted_residual_spec",
    "lower",
    "mobilenet_v1_spec",
    "mobilenet_v2_spec",
    "plan",
    "plan_network",
    "separable_block_spec",
]
