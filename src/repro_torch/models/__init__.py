"""Model substrates of the PyTorch port, after ``repro.models``: the
dense decoder LM (``transformer.LM``) with its layers, attention and the
weight conversion from and to the reference's parameter tree.  MoE,
Mamba2, MLA, M-RoPE and encoder-decoder stacks wait for later slices."""
from . import attention, layers, transformer, weights
from .transformer import LM, build_model
from .weights import params_from_numpy, params_to_numpy, seeded_numpy_params

__all__ = ["attention", "layers", "transformer", "weights", "LM",
           "build_model", "params_from_numpy", "params_to_numpy",
           "seeded_numpy_params"]
