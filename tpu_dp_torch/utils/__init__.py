"""Utilities of the port: the throughput meter."""
