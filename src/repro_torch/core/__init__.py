"""Morpheus core of the PyTorch port: the counterparts of ``repro.core``'s
modules on the simulator's main path (address separation, Bloom
predictor, controller, set-parallel engine, system model, Table-3
policy)."""
