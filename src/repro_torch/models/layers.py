"""Common model layers, after ``repro.models.layers``: norms, RoPE and
M-RoPE, the dense MLP, embeddings and the logits head.

Layouts are the reference's: activations (B, S, D), weights (in, out)
applied as ``x @ W``, the embedding (V, D) over the padded vocabulary.
The three matmuls stay ``torch.matmul``, as the reference left them to
XLA.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig


class Init(NamedTuple):
    """How the reference initialises one parameter: ``normal * scale``,
    ones when ``scale`` is None (a norm's weight), zeros when it is 0
    (Mamba2's ``A_log`` and ``dt_bias``, drawn from no generator).
    ``dtype`` None is the model's dtype; a leaf the reference keeps in
    float32 whatever the model's dtype (the MoE router, ``A_log``,
    ``dt_bias``) names ``torch.float32``.  The ``init_*`` functions return
    trees of these, which ``models.weights`` turns into tensors (from a
    ``torch.Generator``) or numpy arrays (from a seed)."""
    shape: Tuple[int, ...]
    scale: Optional[float]
    dtype: Optional[torch.dtype] = None


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def init_rms(d: int) -> Init:
    return Init((d,), None)


# ---------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32, returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


# ---------------------------------------------------------------- softcap

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------- RoPE

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim // 2), f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    return positions.float()[..., None] * inv


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL M-RoPE: ``positions`` (3, B, S) t/h/w streams; each RoPE
    frequency slot draws its position from its section's stream.  Returns
    (B, S, head_dim // 2) f32."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=positions.device),
        torch.tensor(sections, device=positions.device))      # (half,)
    pos = positions.float()[sec_id]                           # (half, B, S)
    return pos.movedim(0, -1) * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); angles (B, S, D // 2) or (S, D // 2).  Half-split
    rotation (not interleaved), in f32, returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :]     # (B, S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------- MLP

def init_dense_mlp(d: int, f: int) -> dict:
    return {"w_gate": Init((d, f), d ** -0.5),
            "w_up": Init((d, f), d ** -0.5),
            "w_down": Init((f, d), f ** -0.5)}


def dense_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU (``act="silu"``) or GeGLU (tanh-approximated GELU, as
    ``jax.nn.gelu``'s default) MLP; ``p`` holds w_gate, w_up (D, F) and
    w_down (F, D)."""
    a = x @ p["w_gate"]
    a = F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")
    return (a * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------- embed

def init_embed(cfg: ArchConfig) -> dict:
    """The (padded-vocabulary) embedding, and the unembedding when the
    embeddings are not tied."""
    v = cfg.padded_vocab()
    p = {"embed": Init((v, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = Init((cfg.d_model, v), cfg.d_model ** -0.5)
    return p


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Embedding rows of ``tokens`` times sqrt(d_model), which the
    reference applies to every architecture (gemma-style), in the
    embedding's dtype."""
    x = embed[tokens]
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                            device=x.device)


def logits_head(embed: torch.Tensor, unembed, x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """f32 logits over the padded vocabulary: ``x @ embed.T`` when the
    embeddings are tied, else ``x @ unembed``; then the final soft cap."""
    logits = x @ embed.T if cfg.tie_embeddings else x @ unembed
    return softcap(logits.float(), cfg.final_softcap)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean of ``logsumexp - gold`` over the tokens, in f32.  As in the
    reference, the logsumexp runs over the PADDED vocabulary and
    ``vocab_size`` is unused (the reference's docstring says the padded
    tail is masked; its code does not mask it)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
