"""Simulation engine: the per-cell slot loop and the network orchestration
above it (+simulation/ in the reference; SURVEY §2.7)."""

from isac_tpu_torch.sim.cell import CellSimulator
from isac_tpu_torch.sim.network import network_simulation, resolve_los, resolve_los_cross

__all__ = ["CellSimulator", "network_simulation", "resolve_los", "resolve_los_cross"]
