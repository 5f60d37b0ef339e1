"""Model substrates of the PyTorch port, after ``repro.models``: the LM
(``transformer.LM``) over every architecture of ``repro_torch.configs``
(dense, MoE, MLA, Mamba2 and hybrid stacks, encoder-decoder, M-RoPE),
its layers, attention, MoE and Mamba2 mixers, and the weight conversion
from and to the reference's parameter tree."""
from . import attention, layers, mamba2, moe, transformer, weights
from .transformer import LM, build_model
from .weights import (params_from_numpy, params_to_numpy, seeded_numpy_params,
                      seeded_params)

__all__ = ["attention", "layers", "mamba2", "moe", "transformer", "weights",
           "LM", "build_model", "params_from_numpy", "params_to_numpy",
           "seeded_numpy_params", "seeded_params"]
