"""Fault-injection campaigns of the port (counterpart of `rfhe_tpu/faults`)."""
