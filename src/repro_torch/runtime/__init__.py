"""The runtime of the port (counterpart of ``repro.runtime``): the chaos
harness (deterministic fault injection), fault supervision and heartbeats,
and the self-healing long-run driver.

Light on import, as the reference's: :mod:`repro_torch.runtime.chaos` and
:mod:`repro_torch.runtime.fault` are pure Python (the kernel dispatch and
the checkpoint writer import them); :mod:`repro_torch.runtime.resilient`
pulls in the solver stack and is imported explicitly by its consumers.
"""

from repro_torch.runtime.chaos import (
    BackendError,
    Fault,
    FaultPlan,
    InjectedCrash,
    InjectedFault,
    InjectedIOError,
    TransientError,
    WorkerDeath,
    injected,
)
from repro_torch.runtime.fault import (
    Heartbeat,
    HeartbeatStatus,
    StragglerMonitor,
    SupervisorReport,
    read_heartbeat,
    supervise,
)

__all__ = [
    "BackendError",
    "Fault",
    "FaultPlan",
    "Heartbeat",
    "HeartbeatStatus",
    "InjectedCrash",
    "InjectedFault",
    "InjectedIOError",
    "StragglerMonitor",
    "SupervisorReport",
    "TransientError",
    "WorkerDeath",
    "injected",
    "read_heartbeat",
    "supervise",
]
