"""The LM, after ``repro.models.transformer``: decoder-only stacks of
attention (GQA or MLA, global or sliding-window, with or without a logit
soft cap) and Mamba2 layers with dense or MoE MLPs, the encoder-decoder
variant (seamless) and the VLM inputs (qwen2-vl): every architecture of
``repro_torch.configs``.

``LM`` is an ``nn.Module`` on an explicit device and dtype whose layers
are an ``nn.ModuleList`` in layer order (the reference scans over
stacked blocks; ``models.weights`` converts between the two layouts).
Its parameters are made empty; ``init_weights`` draws them from a
``torch.Generator`` with the reference's distributions, and
``weights.params_from_numpy`` loads the reference's tree.  The entry
points (``forward``, ``prefill``, ``decode_step``) run inference only,
under ``torch.no_grad``.

Optional batch inputs, as in the reference: ``frame_embeds`` (B, T, D),
the stubbed audio frontend's frames that the encoder of an
encoder-decoder arch reads; ``patch_embeds`` (B, P, D), a vision prefix
(scaled by sqrt(d_model)) that replaces the first P token embeddings;
``positions`` (B, S) or (3, B, S) M-RoPE streams, which only ``forward``
reads (``prefill`` rotates by ``arange(S)``, as the reference's does).
``prefill`` of an encoder-decoder arch encodes ``frame_embeds`` and keeps
the encoder's output in ``caches.enc_out``; ``decode_step`` projects the
cross K/V from it at every step, as the reference does.

Tensor parallelism: ``distributed.tensor_parallel.distribute_model``
places the parameters on a mesh as DTensors (``LM.mesh`` set).  The
entry points then take the GLOBAL batch on every rank (each rank keeps
its rows, ``batch_input``) and the caches ``init_caches`` places by
``cache_shardings``, run the layers on DTensors under
``mesh_context`` (``implicit_replication``: the plain tensors the model
makes count as replicated), and return the logits whole
(``full_tensor``: the last token's for ``prefill`` and ``decode_step``,
all of them for ``forward``); ``loss`` returns a replicated 0-d DTensor,
differentiable in the DTensor parameters.  A decode step writes position
``cur_pos`` into a sequence-sharded cache on the rank that holds it
(``attention._decode_tp``): the cache is never gathered.

``loss(batch, remat=True)`` is the reference's: the mean cross-entropy
of ``_logits`` over the padded vocabulary.  With ``remat`` each repeat of
the block pattern runs under ``torch.utils.checkpoint`` (non-reentrant),
as the reference wraps its scanned block in ``jax.checkpoint``; the
config's ``remat_policy`` (or ``REPRO_REMAT_POLICY``) ``"dots"`` keeps
the matmul outputs (a selective checkpoint) where ``"full"`` recomputes
the whole block.  Both give the same numbers.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as ckpt

from ..configs.base import ArchConfig, LayerSpec
from ..core.engine import resolve_device
from ..distributed import tensor_parallel as tp
from . import attention as A
from . import layers as L
from . import mamba2 as M
from . import moe as MoE
from . import weights as W

Tensor = torch.Tensor

# what the "dots" remat policy keeps: the matmul outputs (the reference's
# dots_with_no_batch_dims_saveable)
_SAVED_OPS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


class ParamTree(nn.Module):
    """A nested tree of parameters made empty from a ``layers.Init`` tree,
    each leaf in its own dtype or the model's; ``tree["name"]`` reads a
    leaf or a subtree, as the reference's dicts do."""

    def __init__(self, inits: dict, dtype: torch.dtype, device):
        super().__init__()
        for name, init in inits.items():
            if isinstance(init, dict):
                setattr(self, name, ParamTree(init, dtype, device))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(init.shape, dtype=init.dtype or dtype,
                                device=device), requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def param(self, name: str) -> Tensor:
        """A parameter by its dotted name in the reference's layer tree
        (``"mixer.wq"``, ``"mlp.shared.w_up"``, ``"ln1"``)."""
        node = self
        for part in name.split("."):
            node = node[part]
        return node


class Layer(ParamTree):
    """One layer: ``ln1`` and ``mixer`` (an attention's or a Mamba2's
    parameters), ``ln2`` and ``mlp`` (dense or MoE) when the layer has an
    MLP, ``ln_x`` and ``xattn`` when it has a cross-attention block."""


class Caches(list):
    """The per-layer caches in layer order (an attention layer's KV cache,
    a Mamba2 layer's conv and SSM state); ``enc_out`` the encoder's output
    (B, T_enc, D) after ``prefill`` of an encoder-decoder model, else
    None."""
    enc_out: Optional[Tensor] = None


def _caches_unflatten(children, _ctx) -> Caches:
    c = Caches(children[:-1])
    c.enc_out = children[-1]
    return c


# a pytree node, so that what walks a program's arguments (the op
# counter's memory sizes) reaches every cache tensor and ``enc_out``
pytree.register_pytree_node(
    Caches, lambda c: ([*c, c.enc_out], None), _caches_unflatten,
    serialized_type_name=f"{__name__}.Caches")


class LM(nn.Module):
    """Language model over every architecture of ``repro_torch.configs``.

    ``device`` None runs on the CUDA card (``BackendError`` without one);
    ``device="cpu"`` runs the kernels' plain versions; ``device="meta"``
    builds shapes only, for the op counter (``roofline.op_cost``), and
    computes no result.  ``dtype`` None
    takes the config's ``param_dtype``; the MoE router, ``A_log`` and
    ``dt_bias`` stay float32 whatever it is, as in the reference."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = None            # a DeviceMesh after distribute_model
        self.device = resolve_device(device, meta=True)
        self.dtype = dtype or L.dtype_of(cfg)
        for name, init in W.top_inits(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(init.shape, dtype=self.dtype, device=self.device),
                requires_grad=False))
        if cfg.tie_embeddings:
            self.unembed = None
        self.specs: Tuple[LayerSpec, ...] = W.layer_specs(cfg)
        self.layers = nn.ModuleList(
            Layer(W.layer_inits(cfg, s, cross=W.has_cross(cfg, li)),
                  self.dtype, self.device)
            for li, s in enumerate(self.specs))
        self.encoder_layers = nn.ModuleList(
            Layer(W.encoder_inits(cfg), self.dtype, self.device)
            for _ in range(cfg.encoder_layers))
        self.encoder_norm = (nn.Parameter(torch.empty(
            (cfg.d_model,), dtype=self.dtype, device=self.device),
            requires_grad=False) if cfg.is_encdec else None)

    # ------------------------------------------------------------- params
    def _leaves(self):
        """(parameter, ``layers.Init``) of every leaf in a fixed order: top
        level, the decoder layers, the encoder layers, the encoder norm."""
        cfg = self.cfg
        out = [(getattr(self, n), i) for n, i in W.leaves(W.top_inits(cfg))]
        for li, (layer, spec) in enumerate(zip(self.layers, self.specs)):
            out += [(layer.param(n), i) for n, i in W.leaves(
                W.layer_inits(cfg, spec, cross=W.has_cross(cfg, li)))]
        for layer in self.encoder_layers:
            out += [(layer.param(n), i)
                    for n, i in W.leaves(W.encoder_inits(cfg))]
        if cfg.is_encdec:
            out.append((self.encoder_norm, L.init_rms(cfg.d_model)))
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LM":
        """Draw every parameter with the reference's distributions
        (``normal * scale``, norms at one, ``A_log`` and ``dt_bias`` at
        zero) from ``generator``, which must live on the model's device, in
        a fixed order (``_leaves``)."""
        for t, init in self._leaves():
            if init.scale is None:
                t.fill_(1.0)
            elif init.scale == 0:
                t.zero_()
            else:
                t.normal_(generator=generator).mul_(init.scale)
        return self

    # --------------------------------------------------------- the mesh
    def mesh_context(self):
        """The context of a step on DTensors (plain tensors the model
        makes count as replicated), which a backward through ``loss``
        needs too (its recomputation and saved plain tensors); nothing
        off a mesh."""
        return (tp.implicit_replication() if self.mesh is not None
                else contextlib.nullcontext())

    def _input(self, x: Tensor, batch_dim: int = 0) -> Tensor:
        """A batch input on the model's device, placed by ``batch_spec``
        under a mesh."""
        x = x.to(self.device)
        if self.mesh is None:
            return x
        return tp.batch_input(x, self.mesh, batch_dim)

    def _whole(self, x: Tensor) -> Tensor:
        return x.full_tensor() if tp.is_dtensor(x) else x

    # -------------------------------------------------------------- embed
    def _embed(self, tokens: Tensor) -> Tensor:
        return L.embed_tokens(self.embed, self._input(tokens), self.cfg)

    def _embed_inputs(self, batch: Dict[str, Tensor]
                      ) -> Tuple[Tensor, Tensor]:
        """(x (B, S, D), positions) of a batch: the token embeddings with
        a ``patch_embeds`` prefix (scaled by sqrt(d_model)) in place of the
        first P, and ``batch["positions"]`` or ``arange(S)``."""
        tokens = batch["tokens"]
        x = self._embed(tokens)
        if "patch_embeds" in batch:
            pe = self._input(batch["patch_embeds"].to(self.dtype))
            scale = torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=self.device)
            x = torch.cat([pe * scale, x[:, pe.shape[1]:]], dim=1)
        b, s = tokens.shape
        if "positions" in batch:
            positions = batch["positions"]
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=self.device).expand(b, s)
        return x, self._input(positions, positions.dim() - 2)

    def _encode(self, batch: Dict[str, Tensor]) -> Optional[Tensor]:
        """The encoder's output over ``batch["frame_embeds"]`` (B, T, D),
        non-causal, for an encoder-decoder arch; None otherwise."""
        if not self.cfg.is_encdec:
            return None
        x = self._input(batch["frame_embeds"].to(self.dtype))
        b, s, _ = x.shape
        pos = self._input(torch.arange(s, dtype=torch.int32,
                                       device=self.device).expand(b, s))
        for layer in self.encoder_layers:
            h = L.rms_norm(x, layer.ln1)
            x = L.residual(x, A.attention(layer.mixer, h, self.cfg,
                                          W.ENCODER_SPEC, pos, causal=False))
            x = self._mlp(layer, W.ENCODER_SPEC, x)
        return L.gather_rows(L.rms_norm(x, self.encoder_norm))

    def _head(self, x: Tensor) -> Tensor:
        x = L.rms_norm(L.gather_rows(x), self.final_norm)
        return L.logits_head(self.embed, self.unembed, x, self.cfg)

    def _cross(self, layer: Layer, x: Tensor,
               enc_out: Optional[Tensor]) -> Tensor:
        """The cross-attention block over ``enc_out``, K/V projected anew
        (the reference projects them in every scan step)."""
        if enc_out is None or "xattn" not in layer:
            return x
        enc_kv = A.encode_cross_kv(layer.xattn, enc_out, self.cfg)
        h = L.rms_norm(x, layer.ln_x)
        return L.residual(x, A.cross_attention(layer.xattn, h, enc_kv,
                                                self.cfg))

    def _mlp(self, layer: Layer, spec: LayerSpec, x: Tensor) -> Tensor:
        if "mlp" not in layer:
            return x
        h = L.rms_norm(x, layer.ln2)
        if spec.mlp == "moe":
            return L.residual(x, MoE.moe_mlp(layer.mlp, L.gather_rows(h),
                                             self.cfg))
        return L.residual(x, L.dense_mlp(layer.mlp, h, self.cfg.act))

    # ------------------------------------------------------------ forward
    def _layers(self, first: int, stop: int, x: Tensor, positions: Tensor,
                enc_out: Optional[Tensor]) -> Tensor:
        """Decoder layers ``first`` .. ``stop - 1`` of a full forward."""
        for layer, spec in zip(self.layers[first:stop],
                               self.specs[first:stop]):
            h = L.rms_norm(x, layer.ln1)
            if spec.mixer == "mamba":
                h = M.mamba_block(layer.mixer, L.gather_rows(h), self.cfg)
            else:
                h = A.attention(layer.mixer, h, self.cfg, spec, positions)
            x = self._cross(layer, L.residual(x, h), enc_out)
            x = self._mlp(layer, spec, x)
        return x

    def _remat_kwargs(self) -> dict:
        policy = os.environ.get("REPRO_REMAT_POLICY",
                                getattr(self.cfg, "remat_policy", "full"))
        kw = {"use_reentrant": False}
        if policy == "dots":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _SAVED_OPS)
        return kw

    def _logits(self, batch: Dict[str, Tensor], remat: bool = False
                ) -> Tensor:
        """Logits (B, S, V) f32 of a full causal forward, differentiable
        when grad mode is on; ``remat`` recomputes each repeat of the
        block pattern in the backward pass."""
        cfg = self.cfg
        x, positions = self._embed_inputs(batch)
        enc_out = self._encode(batch)
        n_pre, pat = len(cfg.prefix_layers), len(cfg.block_pattern)
        x = self._layers(0, n_pre, x, positions, enc_out)
        remat = remat and torch.is_grad_enabled()
        kw = self._remat_kwargs() if remat else {}
        for blk in range(cfg.num_blocks):
            span = (n_pre + blk * pat, n_pre + (blk + 1) * pat)
            if remat:
                x = ckpt.checkpoint(self._layers, *span, x, positions,
                                    enc_out, **kw)
            else:
                x = self._layers(*span, x, positions, enc_out)
        return self._head(x)

    @torch.no_grad()
    def forward(self, batch: Dict[str, Tensor]) -> Tensor:
        """Logits (B, S, V) of a full causal forward over
        ``batch["tokens"]`` (B, S) and the optional inputs above."""
        with self.mesh_context():
            return self._whole(self._logits(batch))

    def loss(self, batch: Dict[str, Tensor], remat: bool = True) -> Tensor:
        """Mean cross-entropy (f32, 0-d) of the logits against
        ``batch["targets"]`` (B, S), over the padded vocabulary."""
        with self.mesh_context():
            return L.cross_entropy(self._logits(batch, remat=remat),
                                   self._input(batch["targets"]),
                                   self.cfg.vocab_size)

    # ------------------------------------------------------------ serving
    def init_caches(self, batch_size: int, max_len: int) -> Caches:
        """One cache per layer, in layer order, in the model's dtype;
        placed on the model's mesh by ``cache_shardings`` when it has
        one (each rank keeps its block)."""
        cfg = self.cfg
        if self.mesh is not None:
            return Caches(
                tp.distribute_caches(Caches([c]), cfg, self.mesh,
                                     batch_size)[0]
                for c in self._whole_caches(batch_size, max_len))
        return Caches(self._whole_caches(batch_size, max_len))

    def _whole_caches(self, batch_size: int, max_len: int):
        cfg = self.cfg
        return (
            M.init_mamba_cache(cfg, batch_size, self.dtype, self.device)
            if s.mixer == "mamba" else
            A.init_kv_cache(cfg, s, batch_size, max_len, self.dtype,
                            self.device) for s in self.specs)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Tensor], caches: Caches
                ) -> Tuple[Tensor, Caches]:
        """Run the prompt ``batch["tokens"]`` (B, S), filling the caches in
        place; returns (last-token logits (B, V) f32, caches), with
        ``caches.enc_out`` set for an encoder-decoder model."""
        with self.mesh_context():
            logits, caches = self._prefill(batch, caches)
            return self._whole(logits), caches

    def _prefill(self, batch, caches):
        x, _ = self._embed_inputs(batch)
        enc_out = self._encode(batch)
        caches = caches if isinstance(caches, Caches) else Caches(caches)
        for li, cache in enumerate(caches):
            x = self.prefill_layer(li, x, cache, enc_out)
        caches.enc_out = enc_out
        return self._head(L.gather_rows(x)[:, -1:])[:, 0], caches

    def prefill_layer(self, li: int, x: Tensor, cache, enc_out=None,
                      layer: Optional[Layer] = None) -> Tensor:
        """Decoder layer ``li`` of a prefill: its output for input ``x``
        (B, S, D), its cache filled in place.  ``layer`` runs another
        ``Layer`` of the same shapes in its place (an f32 twin of a bf16
        layer, say)."""
        layer = self.layers[li] if layer is None else layer
        spec = self.specs[li]
        h = L.rms_norm(x, layer.ln1)
        if spec.mixer == "mamba":
            h, _ = M.mamba_prefill(layer.mixer, L.gather_rows(h), cache,
                                   self.cfg)
        else:
            h, _ = A.prefill_into_cache(layer.mixer, h, cache, self.cfg,
                                        spec)
        x = self._cross(layer, L.residual(x, h), enc_out)
        return self._mlp(layer, spec, x)

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, caches: Caches, cur_pos: int
                    ) -> Tuple[Tensor, Caches]:
        """tokens (B,); ``cur_pos`` the absolute position of the new
        tokens (shared by the batch).  Updates the caches in place;
        returns (logits (B, V) f32, caches).  Caches without ``enc_out``
        skip the cross-attention blocks, as the reference's do."""
        with self.mesh_context():
            logits, caches = self._decode_step(tokens, caches, cur_pos)
            return self._whole(logits), caches

    def _decode_step(self, tokens, caches, cur_pos):
        x = self._embed(tokens[:, None])
        enc_out = getattr(caches, "enc_out", None)
        for layer, spec, cache in zip(self.layers, self.specs, caches):
            h = L.rms_norm(x, layer.ln1)
            if spec.mixer == "mamba":
                h, _ = M.mamba_decode_step(layer.mixer, h, cache, self.cfg)
            else:
                h, _ = A.decode_attention(layer.mixer, h, cache,
                                          int(cur_pos), self.cfg, spec)
            x = self._cross(layer, x + h, enc_out)
            x = self._mlp(layer, spec, x)
        return self._head(x)[:, 0], caches


def build_model(cfg: ArchConfig, *, device=None,
                dtype: Optional[torch.dtype] = None) -> LM:
    return LM(cfg, device=device, dtype=dtype)
