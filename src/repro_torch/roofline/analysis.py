"""Roofline numbers from an op count, after ``repro.roofline.analysis``.

The reference reads a compiled XLA program: ``cost_analysis()`` for
FLOPs and bytes, ``memory_analysis()`` for sizes, and regexes over the
optimised HLO text for the collectives.  A PyTorch program has no HLO
text, so these read the op counter's ``Cost`` instead
(``op_cost.analyze``), under the reference's keys and kind names; the
collectives are the counter's record of the ``_c10d_functional.*`` ops
it saw.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .op_cost import COLLECTIVES, Cost


def collective_bytes(cost: Cost) -> Tuple[int, Dict[str, int]]:
    """Sum of operand bytes per collective kind over the program."""
    per_kind = {k: int(v) for k, v in cost.collective_by_kind.items()}
    return sum(per_kind.values()), per_kind


def collective_op_counts(cost: Cost) -> Dict[str, int]:
    """Collective ops by kind, every kind of the reference's listed."""
    return {k: int(cost.collective_counts.get(k, 0)) for k in COLLECTIVES}


def cost_dict(cost: Cost) -> Dict[str, float]:
    """The reference's ``cost_analysis()`` keys over a count."""
    return {"flops": float(cost.flops), "bytes accessed": float(cost.bytes)}


def memory_stats(cost: Cost) -> Dict[str, int]:
    """The reference's ``memory_analysis()`` keys over a count:
    arguments and outputs from the tensors passed and returned, temp
    from the counter's peak of live intermediate bytes (on ``meta``) or
    ``torch.cuda.max_memory_allocated`` (on the card); no code is
    generated and nothing is aliased into the outputs' place, so those
    two are 0."""
    return {"argument_size_in_bytes": int(cost.argument_bytes),
            "output_size_in_bytes": int(cost.output_bytes),
            "temp_size_in_bytes": int(cost.temp_bytes),
            "generated_code_size_in_bytes": 0,
            "alias_size_in_bytes": 0}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode counts one
    token per sequence, forward-only (2*N_active per token)."""
    total, active = cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    tokens = shape.global_batch  # decode: 1 new token per sequence
    return 2.0 * active * tokens
