"""The plain reference of the benchmark's configurations: a decoder-only
transformer in PyTorch operations alone, float32, no kernels and no KV
cache, written from the configuration file's sizes.

It computes what the configuration states, which is the model as the
repository defines it (its departures from the published models are
listed in each configuration file under ``departures``):

  * token embeddings times sqrt(d_model);
  * pre-norm layers: RMSNorm (f32, eps ``norm_eps``), GQA attention with
    half-split RoPE (M-RoPE where the positions are (3, B, S) streams)
    and causal softmax at scale hd^-0.5, then a SwiGLU MLP, or an MoE
    MLP: an f32 softmax router, top-k with ties to the lower expert, the
    k weights renormalised, each (token, slot) pair queued at its expert
    in token-major order within one call of the layer and dropped at or
    past the capacity, the shared experts as one SwiGLU MLP added on top;
  * a final RMSNorm and f32 logits over the whole (padded) vocabulary.

Which tokens share an MoE call matters (the capacity and the queue are
per call): ``served_logits`` makes the calls a server makes (a batch's
prompts together, then each decode step), ``forward_logits`` and the
training step one call over the whole batch.  Weights come from
``pbcore.weights``, drawn layer by layer as the forward reaches them.

The comparison runs with TF32 off (``set_tf32(False)``); the control
turns it on.  This module imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

Tensor = torch.Tensor


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def rms_norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope_angles(positions: Tensor, cfg: dict) -> Tensor:
    """(B, S, hd / 2) angles of (B, S) positions, or of (3, B, S) M-RoPE
    streams, each frequency slot reading its section's stream."""
    half = cfg["head_dim"] // 2
    inv = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(half, dtype=torch.float32,
                     device=positions.device) / half))
    if positions.dim() == 3:
        sec = torch.tensor([i for i, n in enumerate(cfg["mrope_sections"])
                            for _ in range(n)], device=positions.device)
        return positions.float()[sec].movedim(0, -1) * inv
    return positions.float()[..., None] * inv


def apply_rope(x: Tensor, ang: Tensor) -> Tensor:
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w: Dict[str, Tensor], h: Tensor, ang: Tensor,
              cfg: dict) -> Tensor:
    b, s, _ = h.shape
    nh, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = apply_rope((h @ w["mixer.wq"]).view(b, s, nh, hd), ang)
    k = apply_rope((h @ w["mixer.wk"]).view(b, s, kv, hd), ang)
    v = (h @ w["mixer.wv"]).view(b, s, kv, hd)
    k = k.repeat_interleave(nh // kv, dim=2)
    v = v.repeat_interleave(nh // kv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).triu(1)
    p = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, v).reshape(b, s, nh * hd)
    return out @ w["mixer.wo"]


def swiglu(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor) -> Tensor:
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def capacity(tokens: int, cfg: dict) -> int:
    """Queue places an expert has in one call over ``tokens`` tokens."""
    cf = cfg["capacity_factor"]
    if cf <= 0:
        c = tokens
    else:
        c = int(tokens * cfg["top_k"] / cfg["num_experts"] * cf)
    return max(8, -(-c // 8) * 8)


def moe(w: Dict[str, Tensor], x2: Tensor, cfg: dict,
        groups: Sequence[Tensor]) -> Tensor:
    """The MoE MLP over rows ``x2`` (T, D); ``groups`` the row indices of
    each call of the layer, in token-major order."""
    e, k = cfg["num_experts"], cfg["top_k"]
    gates = torch.softmax(x2.float() @ w["mlp.router"], dim=-1)
    top_w, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.zeros_like(top_i, dtype=torch.bool)
    for rows in groups:
        flat = top_i[rows].reshape(-1)
        onehot = F.one_hot(flat, e)
        place = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
        keep[rows] = (place < capacity(len(rows), cfg)).view(-1, k)
    y = torch.zeros_like(x2)
    for ex in range(e):
        tok, slot = ((top_i == ex) & keep).nonzero(as_tuple=True)
        if len(tok):
            ye = swiglu(x2[tok], w["mlp.w_gate"][ex], w["mlp.w_up"][ex],
                        w["mlp.w_down"][ex])
            y.index_add_(0, tok, ye * top_w[tok, slot, None])
    if "mlp.shared.w_up" in w:
        y = y + swiglu(x2, w["mlp.shared.w_gate"], w["mlp.shared.w_up"],
                       w["mlp.shared.w_down"])
    return y


def layer(w: Dict[str, Tensor], x: Tensor, ang: Tensor, cfg: dict,
          moe_layer: bool, groups: Optional[Sequence[Tensor]],
          attend: Callable = attention) -> Tensor:
    """One pre-norm layer, its attention ``attend(w, h, ang, cfg)``."""
    eps = cfg["norm_eps"]
    x = x + attend(w, rms_norm(x, w["ln1"], eps), ang, cfg)
    h = rms_norm(x, w["ln2"], eps)
    if moe_layer:
        b, s, d = h.shape
        if groups is None:
            groups = [torch.arange(b * s, device=h.device)]
        return x + moe(w, h.reshape(-1, d), cfg, groups).view(b, s, d)
    return x + swiglu(h, w["mlp.w_gate"], w["mlp.w_up"], w["mlp.w_down"])


def embed(top: Dict[str, Tensor], tokens: Tensor, cfg: dict) -> Tensor:
    return top["embed"][tokens] * math.sqrt(cfg["d_model"])


def head(top: Dict[str, Tensor], x: Tensor, cfg: dict) -> Tensor:
    w = top["embed"].T if cfg.get("tie_embeddings") else top["unembed"]
    return rms_norm(x, top["final_norm"], cfg["norm_eps"]) @ w


def is_moe(cfg: dict, li: int) -> bool:
    return cfg.get("num_experts", 0) > 0 and li >= cfg.get(
        "first_dense_layers", 0)


@torch.no_grad()
def forward_logits(cfg: dict, top: Dict[str, Tensor],
                   layer_weights: Callable[[int], Dict[str, Tensor]],
                   tokens: Tensor, positions: Optional[Tensor] = None,
                   attend: Callable = attention,
                   angles: Callable = rope_angles) -> Tensor:
    """Logits (B, S, V) of a full causal forward over ``tokens`` (B, S),
    every MoE layer one call over all of them.  ``attend`` and ``angles``
    are a layer's attention and its RoPE angles (another layout's, such
    as ``mla.py``'s)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    ang = angles(positions, cfg)
    x = embed(top, tokens, cfg)
    for li in range(cfg["num_layers"]):
        x = layer(layer_weights(li), x, ang, cfg, is_moe(cfg, li), None,
                  attend)
    return head(top, x, cfg)


@torch.no_grad()
def served_logits(cfg: dict, top: Dict[str, Tensor],
                  layer_weights: Callable[[int], Dict[str, Tensor]],
                  batches: List[Tensor], prompt_len: int,
                  attend: Callable = attention,
                  angles: Callable = rope_angles) -> List[Tensor]:
    """Logits (B, L - prompt_len + 1, V) at positions prompt_len - 1 ..
    L - 1 of each batch (B, L) of a served round: its prompts and the
    tokens served after them.  The MoE calls are the server's: the
    prompts of the round together, then each later position alone (one
    decode step).  ``layer_weights(li)`` gives layer ``li``'s weights;
    every batch passes a layer before the next layer is asked for.
    ``attend`` and ``angles`` as in ``forward_logits``."""
    xs, angs, groups = [], [], []
    for toks in batches:
        b, n = toks.shape
        pos = torch.arange(n, device=toks.device).expand(b, n)
        xs.append(embed(top, toks, cfg))
        angs.append(angles(pos, cfg))
        flat = torch.arange(b * n, device=toks.device).view(b, n)
        groups.append([flat[:, :prompt_len].reshape(-1)]
                      + [flat[:, t] for t in range(prompt_len, n)])
    for li in range(cfg["num_layers"]):
        w = layer_weights(li)
        xs = [layer(w, x, a, cfg, is_moe(cfg, li), g, attend)
              for x, a, g in zip(xs, angs, groups)]
        del w
    return [head(top, x[:, prompt_len - 1:], cfg) for x in xs]


class TrainReference:
    """The training step of the configuration in plain PyTorch: the mean
    cross-entropy over the vocabulary (each layer recomputed in the
    backward, to fit), ``torch.autograd`` gradients and AdamW with
    global-norm clipping and decoupled weight decay, as the configuration
    states them.  ``params`` maps ``"embed"``, ``"unembed"``,
    ``"final_norm"`` and ``"layers.<i>.<leaf>"`` to tensors."""

    def __init__(self, cfg: dict, opt: dict, params: Dict[str, Tensor]):
        self.cfg, self.opt = cfg, opt
        self.params = {k: v.detach().requires_grad_(True)
                       for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.step_count = 0

    def _layer(self, li: int):
        pre = f"layers.{li}."
        return {k[len(pre):]: v for k, v in self.params.items()
                if k.startswith(pre)}

    def loss(self, batch: Dict[str, Tensor]) -> Tensor:
        cfg = self.cfg
        tokens = batch["tokens"]
        pos = batch.get("positions")
        if pos is None:
            b, s = tokens.shape
            pos = torch.arange(s, device=tokens.device).expand(b, s)
        ang = rope_angles(pos, cfg)
        top = {k: self.params[k] for k in ("embed", "unembed", "final_norm")
               if k in self.params}
        x = embed(top, tokens, cfg)
        for li in range(cfg["num_layers"]):
            w = self._layer(li)
            names = sorted(w)
            fn = (lambda x_, *ws, li=li, names=names: layer(
                dict(zip(names, ws)), x_, ang, cfg, is_moe(cfg, li), None))
            x = checkpoint.checkpoint(fn, x, *[w[n] for n in names],
                                      use_reentrant=False)
        logits = head(top, x, cfg).float()
        gold = logits.gather(-1, batch["targets"].long()[..., None])[..., 0]
        return (torch.logsumexp(logits, -1) - gold).mean()

    def decayed(self, name: str) -> bool:
        """Weight decay where the repository's AdamW decays: leaves of
        rank >= 2 in its stacked layout, so every leaf of a block layer
        (the layers after ``first_dense_layers``; norms included) and the
        matrices outside them, not the final norm."""
        if name.startswith("layers."):
            li = int(name.split(".")[1])
            if li >= self.cfg.get("first_dense_layers", 0):
                return True
        return self.params[name].dim() >= 2

    def step(self, batch: Dict[str, Tensor]) -> Dict[str, object]:
        """One training step; returns its loss and the norm of each
        leaf's gradient as the optimizer takes it (after clipping)."""
        o = self.opt
        names = list(self.params)
        loss = self.loss(batch)
        grads = list(torch.autograd.grad(
            loss, [self.params[n] for n in names]))
        with torch.no_grad():
            gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
            scale = torch.clamp(o["clip_norm"] / (gn + 1e-9), max=1.0)
            self.step_count += 1
            t = torch.tensor(float(self.step_count))
            c1 = float(1 - torch.tensor(o["b1"]) ** t)
            c2 = float(1 - torch.tensor(o["b2"]) ** t)
            norms = {}
            for i, n in enumerate(names):
                g = grads[i] * scale
                grads[i] = None
                norms[n] = float(torch.linalg.vector_norm(g))
                p, m, v = self.params[n], self.m[n], self.v[n]
                m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                v.mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
                u = (m / c1) / (torch.sqrt(v / c2) + o["eps"])
                if o["weight_decay"] and self.decayed(n):
                    u = u + o["weight_decay"] * p
                p.sub_(o["lr"] * u)
        return {"loss": float(loss.detach()), "grad_norms": norms}
