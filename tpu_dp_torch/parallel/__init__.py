"""Process groups, device resolution and cross-rank reductions of the port
(one process drives one device)."""
