"""Decoder-only transformer — ``repro.models.transformer`` on PyTorch.

The reference scans over stacked layer parameters; here the layers are an
``nn.ModuleList`` walked by a Python loop, flat in execution order
(``local, global, local, …`` for alternating stacks, which the reference
scans as pairs).  A block's FFN is dense (``silu(g)·h``) or, with
``n_experts > 0``, the Mixture-of-Experts layer (``moe.py``); the forward
returns the layers' aux losses summed in layer order, as the reference's
scan carries them.

`TransformerConfig` has the reference's fields minus ``use_flash``: which
attention runs follows the device (see ``attention.py``).  ``scan_layers``
is kept so configurations read the same, and ignored: the port always
loops.  ``remat`` is the reference's per-layer recomputation: under grad,
each of its checkpoint units — one layer, or one (local, global) pair of
an alternating stack, the reference's scan step — runs through
``common.remat`` (``torch.utils.checkpoint``, the policy from
``REPRO_REMAT_POLICY``: ``full`` by default, ``dots``, ``none``), so the
backward recomputes the unit's activations instead of holding them.  The
layers' aux losses are summed outside the units, once.  A forward that
fills a decode cache, and any forward without grad, runs as is.

A training model (`transformer_init` with ``train``) keeps the
reference's f32 masters and casts them to ``cfg.dtype`` at each use, as
the reference does; a serving model (`for_serving`) stores its dense
weights, experts and embedding rounded once, frozen, and is built one
layer at a time (drawn in f32, rounded, the f32 copy freed), so that its
peak is the rounded weights plus one layer in f32.  `transformer_apply` and `lm_loss` run under autograd; serving
enters ``torch.inference_mode()`` at its own call sites.

Under a mesh (``models.sharding``, the reference's constrain points) each
rank holds its shards (`transformer_init_sharded`, or
``sharding.shard_parameters_`` of a whole model) and its rows of the
batch; the residual stream is split over the model axis along the
sequence (Megatron-SP).  The embedding's vocabulary rows are split: each
rank looks up the tokens in its slice and the partial sums are
reduce-scattered onto the sequence; attention, the FFN (column-parallel
wi / wg, row-parallel wo) and the MoE (experts split) gather the sequence
and reduce-scatter their partial sums back; the logits keep the rank's
vocabulary slice and `lm_loss` reduces ``logsumexp`` and the gold logit
over the model axis (``sharding.vocab_parallel_xent``).  `lm_loss`
returns the rank's share of the global loss: its rows' mean over the
data ranks' count, so that the step's data-axis sum is the global mean.
A 1×1 mesh computes exactly what no mesh does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from .attention import (
    Attention,
    AttentionConfig,
    Cache,
    init_cache,
    mha_decode,
    mha_train,
)
from .common import (
    RESIDUAL,
    Dense,
    RMSNorm,
    embed_apply,
    for_serving,
    normal_,
    remat,
    round_for_serving,
    row_parallel,
    silu,
    softcap,
)
from .moe import MoE, MoEConfig
from .sharding import (axis_index, constrain, current_mesh, extent,
                       scale_grad, shard_parameters_, vocab_parallel_xent)

__all__ = ["TransformerConfig", "Transformer", "transformer_init",
           "transformer_init_sharded", "transformer_apply", "lm_loss",
           "init_decode_cache", "transformer_decode"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int                          # dense-FFN hidden (ignored if MoE)
    # --- MoE (n_experts == 0 → dense) ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # --- attention variant ---
    window: Optional[int] = None       # sliding window (all layers)
    local_global: bool = False         # alternate local(window)/global layers
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_base: float = 10000.0
    # --- execution ---
    remat: bool = True                 # per-unit recomputation (module doc)
    attn_impl: str = "dense"           # CPU only: "dense" | "chunked"
    q_chunk: int = 512
    kv_chunk: int = 1024
    scan_layers: bool = True           # kept, ignored (always a loop)
    dtype: Any = torch.bfloat16

    def attn_cfg(self, *, local: bool) -> AttentionConfig:
        win = self.window if (local or not self.local_global) else None
        return AttentionConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            rope_base=self.rope_base,
            qk_norm=self.qk_norm,
            logit_softcap=self.attn_softcap,
            window=win,
        )

    @property
    def moe_cfg(self) -> Optional[MoEConfig]:
        if self.n_experts == 0:
            return None
        return MoEConfig(self.d_model, self.moe_d_ff, self.n_experts,
                         self.top_k, capacity_factor=self.moe_capacity_factor)

    @property
    def layers_per_step(self) -> int:
        return 2 if self.local_global else 1

    @property
    def n_scan_steps(self) -> int:
        assert self.n_layers % self.layers_per_step == 0
        return self.n_layers // self.layers_per_step

    def layer_is_local(self, i: int) -> bool:
        """Layer i of the flat stack: the first of each (local, global)
        pair is local."""
        return self.local_global and i % 2 == 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers), for 6·N·D."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads * 2) + d * hd * (self.n_kv_heads * 2)
        if self.n_experts:
            ffn = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.vocab * d + self.n_layers * per_layer + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        inactive = (self.n_layers * (self.n_experts - self.top_k) * 3
                    * self.d_model * self.moe_d_ff)
        return full - inactive


class FFN(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.wi = Dense(cfg.d_model, cfg.d_ff, device=device)
        self.wg = Dense(cfg.d_model, cfg.d_ff, device=device)
        self.wo = Dense(cfg.d_ff, cfg.d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = constrain(x, "batch", "seq", "embed", src=RESIDUAL)
        h = constrain(silu(self.wg(x)) * self.wi(x), "batch", "seq", "mlp")
        return row_parallel(self.wo, h)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.wi, self.wg, self.wo):
            lin.reset_parameters(generator)


class Block(nn.Module):
    """Attention, then ``ffn`` (dense) or ``moe`` (``n_experts > 0``)."""

    def __init__(self, cfg: TransformerConfig, *, local: bool, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, device=device)
        self.ln_ffn = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg.attn_cfg(local=local), device=device)
        if cfg.moe_cfg is not None:
            self.moe = MoE(cfg.moe_cfg, dtype=cfg.dtype, device=device)
        else:
            self.ffn = FFN(cfg, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln_attn.reset_parameters()
        self.ln_ffn.reset_parameters()
        self.attn.reset_parameters(generator)
        (self.moe if hasattr(self, "moe") else self.ffn).reset_parameters(
            generator)

    def _mlp(self, x) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The FFN of ln_ffn(x) and its aux loss (None for a dense FFN)."""
        h = self.ln_ffn(x)
        if hasattr(self, "moe"):
            return self.moe(h)
        return self.ffn(h), None

    def forward(self, x, positions, cfg: TransformerConfig,
                cache: Optional[Cache] = None):
        # under a mesh x, the attention's and the FFN's outputs all hold
        # the residual layout (the reference's constrain of x + a, x + f)
        x = x + mha_train(self.attn, self.ln_attn(x), positions,
                          impl=cfg.attn_impl, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk, cache=cache)
        f, aux = self._mlp(x)
        return x + f, aux

    def decode(self, x, cache: Cache, position):
        a, cache = mha_decode(self.attn, cache, self.ln_attn(x), position)
        x = x + a
        return x + self._mlp(x)[0], cache


class Transformer(nn.Module):
    """``embed`` (vocab, d_model) in f32 (``cfg.dtype`` once
    `for_serving`), ``layers``, ``ln_final``; the output projection is the
    tied embedding."""

    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.serve_dtype = {"embed": cfg.dtype}
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, device=device,
                        dtype=torch.float32))
        self.layers = nn.ModuleList(
            Block(cfg, local=cfg.layer_is_local(i), device=device)
            for i in range(cfg.n_layers))
        self.ln_final = RMSNorm(cfg.d_model, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init distributions: embedding N(0, 1), dense
        N(0, 1/fan_in), experts as ``moe.MoE``'s, norm scales 1."""
        normal_(self.embed, 1.0, generator)
        for blk in self.layers:
            blk.reset_parameters(generator)
        self.ln_final.reset_parameters()


def transformer_init(cfg: TransformerConfig, generator: torch.Generator, *,
                     device=None, train: bool = False) -> Transformer:
    """Random weights from ``generator`` (on ``device``'s type): f32
    trainable masters with ``train``, else `for_serving`.  The draws differ
    from ``jax.random``'s; tests carry the reference's weights over with
    ``repro_torch.interop.transformer_params_from_numpy``.

    A serving model is built on the meta device and materialised one
    module at a time in `reset_parameters`'s order (the same draws, so it
    equals ``for_serving`` of the training model): each is drawn in f32
    and rounded before the next is allocated."""
    if train:
        model = Transformer(cfg, device=device)
        model.reset_parameters(generator)
        return model
    if device is None:
        device = torch.get_default_device()
    model = Transformer(cfg, device="meta")
    model.to_empty(device=device, recurse=False)          # the embedding
    normal_(model.embed, 1.0, generator)
    round_for_serving(model)
    for blk in model.layers:
        blk.to_empty(device=device)
        blk.reset_parameters(generator)
        for_serving(blk)
    model.ln_final.to_empty(device=device)
    model.ln_final.reset_parameters()
    return for_serving(model)


def transformer_init_sharded(cfg: TransformerConfig,
                             generator: torch.Generator, specs, mesh, *,
                             device=None) -> Transformer:
    """A training model holding this rank's shards of the parameters
    ``specs`` (name → partition spec) lays out over ``mesh``: the draws of
    `transformer_init` with ``train``, module by module (built on the meta
    device, each module materialised, drawn and cut to its shard before
    the next), so that the peak is the shards plus one whole module."""
    if device is None:
        device = torch.get_default_device()
    model = Transformer(cfg, device="meta")
    model.to_empty(device=device, recurse=False)          # the embedding
    normal_(model.embed, 1.0, generator)
    shard_parameters_(model, specs, mesh, recurse=False)
    for i, blk in enumerate(model.layers):
        blk.to_empty(device=device)
        blk.reset_parameters(generator)
        shard_parameters_(blk, specs, mesh, prefix=f"layers.{i}.")
    model.ln_final.to_empty(device=device)
    model.ln_final.reset_parameters()
    return model


def _embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    mesh = current_mesh()
    if mesh is None or model.embed.shape[0] == cfg.vocab:
        x = embed_apply(model.embed, tokens, dtype=cfg.dtype) * scale
        return constrain(x, *RESIDUAL, src=("batch", "seq", "embed"))
    # this rank's vocabulary rows: its tokens' rows, zeros for the others'
    # (one rank holds each token, so the reduce-scatter sums exactly)
    rows = model.embed.shape[0]
    ids = tokens.long() - axis_index(mesh, "model") * rows
    mine = (ids >= 0) & (ids < rows)
    x = embed_apply(model.embed, torch.where(mine, ids, 0), dtype=cfg.dtype)
    x = torch.where(mine[..., None], x * scale, torch.zeros((), dtype=x.dtype))
    return constrain(x, *RESIDUAL, partial="model")


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits (this rank's vocabulary slice under a mesh)."""
    cfg = model.cfg
    x = constrain(model.ln_final(x), "batch", "seq", "embed", src=RESIDUAL)
    logits = torch.einsum("bsd,vd->bsv", x, model.embed.to(cfg.dtype))
    return constrain(softcap(logits, cfg.final_softcap), "batch", "seq",
                     "vocab")


def transformer_apply(model: Transformer, tokens: torch.Tensor,
                      cache: Optional[List[Cache]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int → (logits (B, S, V) in cfg.dtype, aux_loss).

    With ``cache`` (from `init_decode_cache`, at least S positions) the
    forward also fills it, so decoding can go on at position S: a serving
    prefill.  The reference replays the prompt through decode instead."""
    cfg = model.cfg
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = _embed(model, tokens)
    caches = [None] * len(model.layers) if cache is None else cache
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    # the reference's checkpoint unit: its scan step, one layer or a
    # (local, global) pair
    k = cfg.layers_per_step
    for i in range(0, len(model.layers), k):
        unit = functools.partial(_run_layers, model.layers[i:i + k], cfg,
                                 caches[i:i + k])
        if cfg.remat and cache is None:
            x, auxes = remat(unit, x, positions)
        else:
            x, auxes = unit(x, positions)
        for a in auxes:
            aux = aux + a
    return _logits(model, x), aux


def _run_layers(blocks, cfg: TransformerConfig, caches, x, positions):
    """``blocks`` in order from ``x``: (x, the MoE blocks' aux losses)."""
    auxes = []
    for blk, layer_cache in zip(blocks, caches):
        x, a = blk(x, positions, cfg, layer_cache)
        if a is not None:
            auxes.append(a)
    return x, auxes


def lm_loss(model: Transformer, tokens: torch.Tensor, targets: torch.Tensor,
            *, aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy: f32 logits, ``logsumexp − gold``, plus
    ``aux_weight · aux`` (the reference's ``lm_loss``).  Under a mesh the
    rank's share of it (module doc)."""
    logits, aux = transformer_apply(model, tokens)
    logits = logits.float()
    if logits.shape[-1] == model.cfg.vocab:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        xent = logz - gold
    else:
        xent = vocab_parallel_xent(logits, targets)
    loss = xent.mean()
    n_data, n_model = extent("batch"), extent("residual")
    if n_model > 1:     # every model rank computes the same aux loss
        aux = scale_grad(aux, 1.0 / n_model)
    loss = loss + aux_weight * aux
    return loss / n_data if n_data > 1 else loss


def init_decode_cache(cfg: TransformerConfig, batch: int, max_seq: int, *,
                      device=None) -> List[Cache]:
    """One ``{"k", "v"}`` cache per layer, in the flat layer order."""
    return [init_cache(cfg.attn_cfg(local=cfg.layer_is_local(i)), batch,
                       max_seq, cfg.dtype, device)
            for i in range(cfg.n_layers)]


@torch.no_grad()
def transformer_decode(model: Transformer, cache: List[Cache],
                       tokens: torch.Tensor, positions: torch.Tensor
                       ) -> Tuple[torch.Tensor, List[Cache]]:
    """One decode step. tokens: (B, 1); positions: (B,). Returns
    (logits (B, 1, V), cache), the cache updated in place."""
    x = _embed(model, tokens)
    for blk, layer_cache in zip(model.layers, cache):
        x, _ = blk.decode(x, layer_cache, positions)
    return _logits(model, x), cache
