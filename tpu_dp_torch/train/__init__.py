"""Step factories of the port (this slice: the inference half)."""
