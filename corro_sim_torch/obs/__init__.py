"""Host-side observability of a run: the flight recorder and the probe
trace."""

from corro_sim_torch.obs.flight import FlightRecorder
from corro_sim_torch.obs.probes import ProbeTrace

__all__ = ["FlightRecorder", "ProbeTrace"]
