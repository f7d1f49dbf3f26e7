"""Host-side observability of a run: the flight recorder."""

from corro_sim_torch.obs.flight import FlightRecorder

__all__ = ["FlightRecorder"]
