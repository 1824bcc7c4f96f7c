"""Parallelism of the port: band and tile slicing (``bands.py``),
multi-session serving (``sessions.py``, ``serving.py``), the fleet's
session lifecycle (``lifecycle.py``) and the occupancy scheduler
(``occupancy.py``)."""

from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder, partition_devices
from selkies_tpu_torch.parallel.lifecycle import (
    Admission,
    DrainController,
    SessionCheckpoint,
    SessionPlacer,
    checkpoint_session,
    drain_timeout_from_env,
    install_signal_handlers,
    restore_session,
)
from selkies_tpu_torch.parallel.occupancy import (
    BatchPipeline,
    MixedTenancyService,
    OccupancyScheduler,
    SessionPipeline,
    occupancy_enabled,
)
from selkies_tpu_torch.parallel.serving import (
    TorchBandedFleetService,
    TorchMultiSessionH264Service,
)
from selkies_tpu_torch.parallel.sessions import TorchMultiSessionEncoder

__all__ = [
    "Admission",
    "BatchPipeline",
    "DrainController",
    "MixedTenancyService",
    "OccupancyScheduler",
    "SessionCheckpoint",
    "SessionPipeline",
    "SessionPlacer",
    "TorchBandedFleetService",
    "TorchBandedH264Encoder",
    "TorchMultiSessionEncoder",
    "TorchMultiSessionH264Service",
    "checkpoint_session",
    "drain_timeout_from_env",
    "install_signal_handlers",
    "occupancy_enabled",
    "partition_devices",
    "restore_session",
]
