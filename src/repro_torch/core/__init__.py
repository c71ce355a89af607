"""Scheduler-facing numerics the port needs (the measured l(b) profile)."""

from .calibration import LatencyProfile, measured_profile

__all__ = ["LatencyProfile", "measured_profile"]
