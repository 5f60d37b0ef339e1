"""The decoder-only LM, after ``repro.models.transformer``, for dense
attention stacks (GQA, qk-norm, global and sliding-window layers, dense
SwiGLU/GeGLU MLPs, tied or untied embeddings).

``LM`` is an ``nn.Module`` on an explicit device and dtype whose layers
are an ``nn.ModuleList`` in layer order (the reference scans over
stacked blocks; ``models.weights`` converts between the two layouts).
Its parameters are made empty; ``init_weights`` draws them from a
``torch.Generator`` with the reference's distributions, and
``weights.params_from_numpy`` loads the reference's tree.  The entry
points (``forward``, ``prefill``, ``decode_step``) run inference only,
under ``torch.no_grad``; ``loss`` waits for the training slice.

Not ported yet (``LM(cfg)`` raises ``NotImplementedError`` naming the
ROADMAP item): Mamba2 mixers, MoE MLPs, MLA, M-RoPE, encoder-decoder
stacks, and an attention logit soft cap.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig, LayerSpec
from ..core.engine import resolve_device
from . import attention as A
from . import layers as L
from . import weights as W

Tensor = torch.Tensor


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run."""
    specs = W.layer_specs(cfg)
    if any(s.mixer == "mamba" for s in specs):
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 layers are not ported yet (ROADMAP A12)")
    if any(s.mlp == "moe" for s in specs):
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP A12)")
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder stacks and cross-attention are "
            f"not ported yet (ROADMAP A12)")
    A.check_supported(cfg)


def _params(tree: dict, dtype: torch.dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(torch.empty(v.shape, dtype=dtype, device=device),
                        requires_grad=False)
        for k, v in tree.items()})


class Layer(nn.Module):
    """One dense attention layer: ``ln1``, ``mixer`` (the attention's
    parameters), and ``ln2``, ``mlp`` when the layer has an MLP."""

    def __init__(self, inits: dict, dtype: torch.dtype, device):
        super().__init__()
        for name, init in inits.items():
            if isinstance(init, dict):
                setattr(self, name, _params(init, dtype, device))
            else:
                setattr(self, name, nn.Parameter(
                    torch.empty(init.shape, dtype=dtype, device=device),
                    requires_grad=False))

    def param(self, name: str) -> Tensor:
        """A parameter by its dotted name in the reference's layer tree
        (``"mixer.wq"``, ``"ln1"``)."""
        head, _, leaf = name.partition(".")
        return getattr(self, head)[leaf] if leaf else getattr(self, head)


class LM(nn.Module):
    """Decoder-only language model over dense attention layers.

    ``device`` None runs on the CUDA card (``BackendError`` without one);
    ``device="cpu"`` runs the kernels' plain versions.  ``dtype`` None
    takes the config's ``param_dtype``."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype or L.dtype_of(cfg)
        for name, init in W.top_inits(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(init.shape, dtype=self.dtype, device=self.device),
                requires_grad=False))
        if cfg.tie_embeddings:
            self.unembed = None
        self.specs: Tuple[LayerSpec, ...] = W.layer_specs(cfg)
        self.layers = nn.ModuleList(
            Layer(W.layer_inits(cfg, s), self.dtype, self.device)
            for s in self.specs)

    # ------------------------------------------------------------- params
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LM":
        """Draw every parameter with the reference's distributions
        (``normal * scale``, norms at one) from ``generator``, which must
        live on the model's device, in a fixed order (top level, then the
        layers in order)."""
        named = [(getattr(self, n), i) for n, i in
                 W.leaves(W.top_inits(self.cfg))]
        for layer, spec in zip(self.layers, self.specs):
            named += [(layer.param(n), i) for n, i in
                      W.leaves(W.layer_inits(self.cfg, spec))]
        for t, init in named:
            if init.scale is None:
                t.fill_(1.0)
            else:
                t.normal_(generator=generator).mul_(init.scale)
        return self

    # -------------------------------------------------------------- embed
    def _embed(self, tokens: Tensor) -> Tensor:
        return L.embed_tokens(self.embed, tokens.to(self.device), self.cfg)

    def _head(self, x: Tensor) -> Tensor:
        x = L.rms_norm(x, self.final_norm)
        return L.logits_head(self.embed, self.unembed, x, self.cfg)

    def _mlp(self, layer: Layer, x: Tensor) -> Tensor:
        if not hasattr(layer, "mlp"):
            return x
        h = L.rms_norm(x, layer.ln2)
        return x + L.dense_mlp(layer.mlp, h, self.cfg.act)

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def forward(self, batch: Dict[str, Tensor]) -> Tensor:
        """Logits (B, S, V) of a full causal forward over
        ``batch["tokens"]`` (B, S)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        for layer, spec in zip(self.layers, self.specs):
            h = L.rms_norm(x, layer.ln1)
            x = x + A.attention(layer.mixer, h, self.cfg, spec, positions)
            x = self._mlp(layer, x)
        return self._head(x)

    # ------------------------------------------------------------ serving
    def init_caches(self, batch_size: int, max_len: int
                    ) -> List[Dict[str, Tensor]]:
        """One KV cache per layer, in layer order, in the model's dtype."""
        return [A.init_kv_cache(self.cfg, s, batch_size, max_len,
                                self.dtype, self.device) for s in self.specs]

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Tensor], caches: List[Dict[str, Tensor]]
                ) -> Tuple[Tensor, List[Dict[str, Tensor]]]:
        """Run the prompt ``batch["tokens"]`` (B, S), filling the caches in
        place; returns (last-token logits (B, V) f32, caches)."""
        x = self._embed(batch["tokens"])
        for layer, spec, cache in zip(self.layers, self.specs, caches):
            h = L.rms_norm(x, layer.ln1)
            h, _ = A.prefill_into_cache(layer.mixer, h, cache, self.cfg, spec)
            x = self._mlp(layer, x + h)
        return self._head(x[:, -1:])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, caches: List[Dict[str, Tensor]],
                    cur_pos: int) -> Tuple[Tensor, List[Dict[str, Tensor]]]:
        """tokens (B,); ``cur_pos`` the absolute position of the new
        tokens (shared by the batch).  Updates the caches in place;
        returns (logits (B, V) f32, caches)."""
        x = self._embed(tokens[:, None])
        for layer, spec, cache in zip(self.layers, self.specs, caches):
            h = L.rms_norm(x, layer.ln1)
            h, _ = A.decode_attention(layer.mixer, h, cache, int(cur_pos),
                                      self.cfg, spec)
            x = self._mlp(layer, x + h)
        return self._head(x)[:, 0], caches


def build_model(cfg: ArchConfig, *, device=None,
                dtype: Optional[torch.dtype] = None) -> LM:
    return LM(cfg, device=device, dtype=dtype)
