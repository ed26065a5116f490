"""Step watchdog, fleet heartbeats and failure injection
(``repro.runtime``, copied: host-only Python)."""
from repro_torch.runtime.failures import FailureInjector, SimulatedFailure
from repro_torch.runtime.watchdog import HeartbeatMonitor, StepWatchdog

__all__ = ["StepWatchdog", "HeartbeatMonitor", "FailureInjector",
           "SimulatedFailure"]
