"""Adasum math, fusion layouts, the fused bucketed combine, ADASUMRVH
across ranks (`rvh`) and the distributed optimizer (the port's
`repro/core`)."""
