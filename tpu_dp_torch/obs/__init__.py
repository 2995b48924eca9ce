"""Host-side telemetry of the port: counters and spans."""
