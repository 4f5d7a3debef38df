"""Event-stream data for the SNN workloads."""
