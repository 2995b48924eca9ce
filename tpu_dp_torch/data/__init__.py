"""Data helpers for the port: CIFAR normalize and the synthetic set."""
