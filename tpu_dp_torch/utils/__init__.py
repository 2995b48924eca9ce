"""Utilities of the port: the throughput meter and the profiler hooks."""
