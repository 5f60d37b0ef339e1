"""NVIDIA H100 hardware constants for the roofline analysis, after
``repro.roofline.hw`` (whose ``TPUChip`` this ``H100`` record replaces).

The rates are those of NVIDIA's H100 SXM5 datasheet, dense (no
sparsity), at its 700 W power limit:

  * 67 TFLOP/s float32 on the CUDA cores: the port runs f32 with TF32
    off, so its f32 matmuls and kernels never reach the tensor cores;
  * 989 TFLOP/s bf16 on the tensor cores;
  * 3.35 TB/s of HBM3, 80 GB;
  * NVLink 4: 18 links a card, 900 GB/s both directions together, so
    25 GB/s a link in each direction (what one card's sends leave at).

A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs
slower under load; every measured share stands beside the card's name
and limit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class H100:
    peak_flops_f32: float = 67e12     # FLOP/s, CUDA cores
    peak_flops_bf16: float = 989e12   # FLOP/s, tensor cores, dense
    hbm_Bps: float = 3.35e12          # bytes/s
    nvlink_Bps_per_link: float = 25e9  # bytes/s a link, one direction
    nvlink_links: int = 18
    hbm_bytes: int = 80 * 10 ** 9

    def peak_flops(self, dtype: torch.dtype = torch.float32) -> float:
        """The peak for work in ``dtype``: bf16 and fp16 on the tensor
        cores, everything else at the f32 rate of the CUDA cores."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_flops_bf16
        return self.peak_flops_f32


CHIP = H100()


def roofline_terms(*, flops: float, bytes_hbm: float, bytes_collective: float,
                   chips: int, chip: H100 = CHIP,
                   dtype: torch.dtype = torch.float32) -> dict:
    """The three roofline terms in seconds, as the reference's (totals
    are whole-program, so divided by the chip count; collective bytes
    cross ``nvlink_links`` links each).  The compute term takes the peak
    of the work's ``dtype``: the port serves and trains in f32 by
    default."""
    t_compute = flops / (chips * chip.peak_flops(dtype))
    t_memory = bytes_hbm / (chips * chip.hbm_Bps)
    t_coll = bytes_collective / (chips * chip.nvlink_Bps_per_link
                                 * chip.nvlink_links)
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    total = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": total,
        "roofline_fraction": (t_compute / total) if total > 0 else 0.0,
    }
