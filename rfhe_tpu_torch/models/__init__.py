"""Workloads on the scheme layer of the port."""
