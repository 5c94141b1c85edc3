"""The Monte Carlo engine (port of `repro.core.mc`): problems, sampling,
slots, exec, plan, costmodel and engine.

Re-exports the names the sweep server and its launcher take from the
package, as the reference's `repro.core.mc` does.
"""
from repro_torch.core.mc.costmodel import (
    CalibrationConfig,
    CostModel,
    Workload,
    analytic_cost_model,
    load_cost_model,
)
from repro_torch.core.mc.engine import (
    ChannelBatch,
    MCResult,
    energy_to_target,
    run_mc,
    slice_result,
)
from repro_torch.core.mc.exec import (
    cache_epoch,
    clear_cache,
    draw_scratch_bytes,
    estimate_peak_bytes,
    static_signature,
    trace_count,
)
from repro_torch.core.mc.plan import (
    ExecPlan,
    RetryPolicy,
    auto_plan,
    validate_plan,
)
from repro_torch.core.mc.problems import (
    PROBLEMS,
    MCProblem,
    MCProblemBatch,
    ProblemSpec,
    localization_mc_problem,
    logistic_mc_problem,
    quadratic_mc_problem,
    register_problem,
)
from repro_torch.core.mc.slots import (
    ALGO_REGISTRY,
    AlgoSpec,
    SlotCtx,
    register_algo,
)

__all__ = [
    "ALGO_REGISTRY",
    "AlgoSpec",
    "CalibrationConfig",
    "ChannelBatch",
    "CostModel",
    "ExecPlan",
    "MCProblem",
    "MCProblemBatch",
    "MCResult",
    "PROBLEMS",
    "ProblemSpec",
    "RetryPolicy",
    "SlotCtx",
    "Workload",
    "analytic_cost_model",
    "auto_plan",
    "cache_epoch",
    "clear_cache",
    "draw_scratch_bytes",
    "energy_to_target",
    "estimate_peak_bytes",
    "load_cost_model",
    "localization_mc_problem",
    "logistic_mc_problem",
    "quadratic_mc_problem",
    "register_algo",
    "register_problem",
    "run_mc",
    "slice_result",
    "static_signature",
    "trace_count",
    "validate_plan",
]
