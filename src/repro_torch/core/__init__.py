"""Core contribution of the paper: GBMA over-the-air gradient aggregation
(port of `repro.core`): channel models, the GBMA tiers, the baselines,
the channel-transport layer, the waveform check, theory and the Monte
Carlo engine. Re-exports the reference package's public names."""
from repro_torch.core.channel import (
    ChannelConfig,
    edge_noise_std,
    received_snr_db,
    sample_complex_gains,
    sample_gains,
)
from repro_torch.core.gbma import (
    GBMAConfig,
    GBMASimulator,
    blind_ota_aggregate,
    gbma_value_and_grad,
    node_weights,
    ota_aggregate,
    perturb_gradients,
    shard_map_aggregate,
)
from repro_torch.core.baselines import CentralizedGD, FDMGD, PowerControlOTA
from repro_torch.core.mc import (
    ChannelBatch,
    MCProblem,
    MCProblemBatch,
    MCResult,
    localization_mc_problem,
    logistic_mc_problem,
    quadratic_mc_problem,
    register_algo,
    register_problem,
    run_mc,
)
from repro_torch.core import theory, transport, waveform

__all__ = [
    "ChannelBatch",
    "ChannelConfig",
    "MCProblem",
    "MCProblemBatch",
    "MCResult",
    "localization_mc_problem",
    "logistic_mc_problem",
    "quadratic_mc_problem",
    "register_algo",
    "register_problem",
    "run_mc",
    "GBMAConfig",
    "GBMASimulator",
    "CentralizedGD",
    "FDMGD",
    "PowerControlOTA",
    "edge_noise_std",
    "received_snr_db",
    "sample_complex_gains",
    "sample_gains",
    "blind_ota_aggregate",
    "gbma_value_and_grad",
    "node_weights",
    "ota_aggregate",
    "perturb_gradients",
    "shard_map_aggregate",
    "theory",
    "transport",
    "waveform",
]
