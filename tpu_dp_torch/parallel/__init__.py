"""Device resolution for the port (one process drives one card)."""
