"""Adasum math, fusion layouts, the fused bucketed combine and the
distributed optimizer (the port's `repro/core`, one-device subset)."""
