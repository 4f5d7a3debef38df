"""Event-stream data for the SNN workloads, and the float -> integer export."""
