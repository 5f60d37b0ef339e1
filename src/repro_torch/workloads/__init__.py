"""Workload generators of the PyTorch port (numpy only)."""
