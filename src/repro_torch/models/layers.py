"""Common model layers, after ``repro.models.layers``: norms, RoPE and
M-RoPE, the dense MLP, embeddings and the logits head.

Layouts are the reference's: activations (B, S, D), weights (in, out)
applied as ``x @ W``, the embedding (V, D) over the padded vocabulary.
The three matmuls stay ``torch.matmul``, as the reference left them to
XLA.

Under tensor parallelism (DTensor parameters, ``distributed.
tensor_parallel``) the MLP is column- then row-parallel through DTensor's
dispatch, its partial sums reduced once (``reduced``); the embedding is
vocabulary-parallel (each rank looks up the tokens in its rows of the
table, the others' rows give zeros, one all-reduce sums them) and so is
the cross-entropy (``cross_entropy``: a local max and sum of
exponentials over the rank's columns of the logits, each all-reduced
over ``model``; the (B, S, V) logits are never gathered).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed import collectives as C
from ..distributed import tensor_parallel as tp
from ..distributed.tensor_parallel import Partial, Replicate, Shard


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
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], dtype=torch.long,
                          device=positions.device)            # (half,)
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
    a = linear(x, p["w_gate"])
    a = F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")
    return reduced(linear(a * linear(x, p["w_up"]), p["w_down"]))


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; with a DTensor ``w`` per rank in ``local_map`` with the
    placements fixed by ``w``'s: column-parallel (``w`` sharded by its
    columns over ``model``: x whole, the output sharded by its last dim),
    row-parallel (by its rows: x sharded by its last dim, the output
    ``Partial``) or replicated (the output placed as ``x``).  Explicit, so
    that no DTensor strategy re-shards the (B, S) tokens of a product or
    of its gradient."""
    if not tp.is_dtensor(w):
        return x @ w
    last = x.dim() - 1
    wp = tp.on_model(w)
    if seq_sharded(x) and isinstance(wp, Shard):
        # the rank's rows of a context-parallel residual stream: ``w``
        # gathered, the rows kept (GSPMD's choice there too)
        w_pl = tp.with_model(w, Replicate())
        return tp.run_local(torch.matmul, (x, w), (x.placements, w_pl),
                            x.placements, x.device_mesh,
                            (x.placements, tp.grad_placements(w_pl, x,
                                                              True)))
    if wp == Shard(1):
        x_pl = tp.with_model(x, Replicate())
        out_pl = tp.with_model(x, Shard(last))
        x_grad = tp.with_model(x, Partial())
        partial_w = False
    elif wp == Shard(0):
        x_pl = out_pl = x_grad = tp.with_model(x, Shard(last))
        out_pl = tp.with_model(x, Partial())
        partial_w = False
    else:
        own = tp.on_model(x)
        keep = isinstance(own, Shard) and own.dim != last
        x_pl = out_pl = x_grad = tp.with_model(x, own if keep
                                               else Replicate())
        partial_w = keep        # each rank's rows: a partial gradient
    return tp.run_local(torch.matmul, (x, w), (x_pl, w.placements), out_pl,
                        x.device_mesh,
                        (x_grad, tp.grad_placements(w.placements, x,
                                                    partial_w)))


def seq_sharded(x) -> bool:
    """Whether ``x`` is a DTensor whose rows (a dim other than the last)
    are sharded over ``model``: the residual stream under context
    parallelism (``models.attention._context_parallel_constraint``)."""
    if not tp.is_dtensor(x):
        return False
    pl = tp.on_model(x)
    return isinstance(pl, Shard) and pl.dim not in (-1, x.dim() - 1)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank of ``model`` (an all-gather) where its
    rows are sharded there; else as it is.  For a consumer that needs
    every row: the logits head, a Mamba2 scan, the MoE layer."""
    if not seq_sharded(x):
        return x
    return x.redistribute(x.device_mesh, tp.with_model(x, Replicate()))


def residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h`` on the residual stream, kept sequence-sharded over
    ``model`` where either side is: the replicated side takes the rank's
    rows (a local slice, no collective)."""
    if seq_sharded(h) and not seq_sharded(x):
        x = tp.replicate(x).redistribute(x.device_mesh, h.placements)
    elif seq_sharded(x) and not seq_sharded(h):
        h = tp.replicate(h).redistribute(h.device_mesh, x.placements)
    return x + h


def reduced(y: torch.Tensor) -> torch.Tensor:
    """A row-parallel matmul's output summed over ``model`` (DTensor
    ``Partial`` to ``Replicate``, one all-reduce); a plain tensor as it
    is."""
    return tp.replicate(y)


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
    embedding's dtype; vocabulary-parallel on a DTensor table."""
    if tp.is_dtensor(embed):
        x = _embed_parallel(embed, tokens)
        scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.to_local().device)
        return x * scale
    x = embed[tokens]
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                            device=x.device)


def _embed_parallel(embed, tokens):
    """Rows of a DTensor table (vocabulary-sharded over ``model`` or
    replicated) for DTensor ``tokens``: each rank's rows of its slice of
    the vocabulary, zero elsewhere, summed over ``model``."""
    mesh = embed.device_mesh
    sharded = tp.on_model(embed) == Shard(0)
    r = tp.model_rank(mesh)

    def look(w, tok):
        v = w.shape[0]
        idx = tok.long() - (r * v if sharded else 0)
        ok = (idx >= 0) & (idx < v)
        return w[idx.clamp(0, v - 1)] * ok[..., None].to(w.dtype)

    out_pl = tp.with_model(tokens, Partial() if sharded else Replicate())
    grad_pl = tp.grad_placements(embed.placements, tokens,
                                 model_partial=False)
    x = tp.run_local(look, (embed, tokens), (embed.placements,
                                              tokens.placements),
                     out_pl, mesh, (grad_pl, tokens.placements))
    return tp.replicate(x)


def logits_head(embed: torch.Tensor, unembed, x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """f32 logits over the padded vocabulary: ``x @ embed.T`` when the
    embeddings are tied, else ``x @ unembed``; then the final soft cap."""
    w = embed if cfg.tie_embeddings else unembed
    if tp.is_dtensor(w):
        logits = _logits_parallel(w, x, cfg.tie_embeddings)
    else:
        logits = x @ embed.T if cfg.tie_embeddings else x @ unembed
    return softcap(logits.float(), cfg.final_softcap)


def _logits_parallel(w, x, tied: bool):
    """``x @ w.T`` (tied) or ``x @ w`` per rank on its vocabulary columns
    (the logits sharded over ``model``, never gathered); explicit, so that
    DTensor's backward does not re-shard the (B, S) tokens of the
    product's gradient."""
    sharded = tp.on_model(w) == Shard(0 if tied else 1)
    x_pl = tp.with_model(x, Replicate())
    out_pl = tp.with_model(x, Shard(2) if sharded else Replicate())
    x_grad = tp.with_model(x, Partial() if sharded else Replicate())
    return tp.run_local(lambda xl, wl: xl @ (wl.T if tied else wl), (x, w),
                        (x_pl, w.placements), out_pl, x.device_mesh,
                        (x_grad, tp.grad_placements(w.placements, x, False)))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean of ``logsumexp - gold`` over the tokens, in f32.  As in the
    reference, the logsumexp runs over the PADDED vocabulary and
    ``vocab_size`` is unused (the reference's docstring says the padded
    tail is masked; its code does not mask it)."""
    if tp.is_dtensor(logits):
        return _cross_entropy_parallel(logits, targets)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


class _VocabParallelCE(torch.autograd.Function):
    """Sum over the rank's tokens of ``logsumexp - gold`` / ``n_tokens``
    from the rank's vocabulary columns ``lg`` (..., V_local) f32 starting
    at column ``lo``: the max, the sum of exponentials and the gold logit
    each all-reduced over ``group`` (None: the columns are all of V).
    The backward is ``(softmax - onehot) * g / n_tokens`` on the rank's
    columns."""

    @staticmethod
    def forward(ctx, lg, tg, lo, group, n_tokens):
        v = lg.shape[-1]
        mx = lg.max(dim=-1).values
        if group is not None:
            mx = C.all_reduce(mx, group, "max")
        ex = torch.exp(lg - mx[..., None])
        se = ex.sum(-1)
        idx = tg.long() - lo
        ok = (idx >= 0) & (idx < v)
        idx = idx.clamp(0, v - 1)
        gold = torch.gather(lg, -1, idx[..., None])[..., 0] * ok
        if group is not None:
            se = C.all_reduce(se, group)
            gold = C.all_reduce(gold, group)
        ctx.save_for_backward(ex, se, idx, ok)
        ctx.n_tokens = n_tokens
        return (torch.log(se) + mx - gold).sum() / n_tokens

    @staticmethod
    def backward(ctx, g):
        ex, se, idx, ok = ctx.saved_tensors
        grad = ex / se[..., None]
        grad.scatter_add_(-1, idx[..., None], -ok[..., None].to(grad.dtype))
        return grad * (g / ctx.n_tokens), None, None, None, None


def _cross_entropy_parallel(logits, targets):
    """``cross_entropy`` of DTensor logits (the vocabulary sharded over
    ``model`` or replicated, the batch as the activations'): each rank's
    sum over its tokens, vocabulary-parallel, then summed over the batch
    shards."""
    mesh = logits.device_mesh
    if not tp.is_dtensor(targets):
        targets = tp.batch_input(targets, mesh)
    sharded = tp.on_model(logits) == Shard(2)
    group = mesh.get_group(tp.MODEL) if sharded else None
    v_local = logits.shape[-1] // (tp.model_size(mesh) if sharded else 1)
    lo = tp.model_rank(mesh) * v_local if sharded else 0
    n_tokens = targets.numel()
    batch = [isinstance(p, Shard) for p in targets.placements]

    def ce(lg, tg):
        return _VocabParallelCE.apply(lg.float(), tg, lo, group, n_tokens)

    out_pl = tuple(Partial() if b else Replicate() for b in batch)
    loss = tp.run_local(ce, (logits, targets),
                        (logits.placements, targets.placements), out_pl,
                        mesh, (logits.placements, targets.placements))
    return tp.replicate(loss)
