"""Analytic label model of the port: device profiles and the cost model
that gives a graph its (latency, energy, memory) labels."""
from .devices import DEVICES, DeviceProfile
from .cost_model import CostEstimate, estimate, estimate_targets
