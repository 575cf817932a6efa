"""Converters for the state the port shares with the reference.

Numpy in, numpy out: nothing here imports JAX or ``repro``.  A test hands
the reference's arrays (``np.asarray`` of them) to these functions and
compares the port's outputs through them, one function per state type:

  * graphs — `data_graph_from_arrays` rebuilds a `DataGraph` from any object
    with the reference's `DataGraph` attributes;
  * plans — `plan_from_numpy` (from the reference plan's fields);
  * mIS bitmaps — `bitmap_from_uint32` / `bitmap_to_uint32`: the
    reference's ``(⌈n/32⌉,)`` uint32 words ↔ the port's int32 words, the
    same bits;
  * MNI / frac tables — `table_from_numpy` / `table_to_numpy`;
  * transformer weights — `transformer_params_from_numpy` builds the port's
    model from the reference's parameter pytree, and
    `transformer_config_from` its config from the reference's;
  * DLRM and GraphSAGE weights — `dlrm_params_from_numpy`,
    `sage_params_from_numpy`;
  * graph batches — `graph_batch_from_numpy` (from any object with the
    reference's `GraphBatch` fields).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.graph import DataGraph
from .core.plan import _TENSOR_FIELDS, PatternPlan, plan_from_numpy
from .models.dlrm import DLRM, DLRMConfig
from .models.gnn.common import MLP, GraphBatch
from .models.gnn.graphsage import SAGE, SAGEConfig
from .models.transformer import Transformer, TransformerConfig

__all__ = ["data_graph_from_arrays", "plan_from_numpy", "plan_from_fields",
           "bitmap_from_uint32", "bitmap_to_uint32", "table_from_numpy",
           "table_to_numpy", "transformer_config_from",
           "transformer_params_from_numpy", "dlrm_params_from_numpy",
           "sage_params_from_numpy", "graph_batch_from_numpy"]


def data_graph_from_arrays(g) -> DataGraph:
    """A `DataGraph` with the same arrays as ``g`` (any object with the
    reference's `DataGraph` attributes)."""
    return DataGraph(
        n=int(g.n), labels=np.asarray(g.labels, np.int32),
        out_indptr=np.asarray(g.out_indptr, np.int64),
        out_indices=np.asarray(g.out_indices, np.int32),
        in_indptr=np.asarray(g.in_indptr, np.int64),
        in_indices=np.asarray(g.in_indices, np.int32),
        edge_keys=np.asarray(g.edge_keys, np.int64),
        n_labels=int(g.n_labels), undirected=bool(g.undirected))


def plan_from_fields(plan, device="cpu") -> PatternPlan:
    """A port plan from any object with the reference plan's fields (each
    converted with ``np.asarray``)."""
    return plan_from_numpy(plan.k, {f: np.asarray(getattr(plan, f))
                                    for f in _TENSOR_FIELDS},
                           order=getattr(plan, "order", ()), device=device)


def bitmap_from_uint32(words, device="cpu") -> torch.Tensor:
    """uint32 bitmap words (any leading shape) → int32 tensor, same bits."""
    a = np.ascontiguousarray(np.asarray(words, np.uint32))
    return torch.as_tensor(a.view(np.int32).copy()).to(device)


def bitmap_to_uint32(t: torch.Tensor) -> np.ndarray:
    """int32 bitmap tensor → uint32 numpy words, same bits."""
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def table_from_numpy(a, device="cpu") -> torch.Tensor:
    """MNI (bool) or frac (float32) table → tensor of the same dtype."""
    return torch.as_tensor(np.array(a)).to(device)


def table_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def transformer_config_from(cfg) -> TransformerConfig:
    """The port's `TransformerConfig` with the fields of ``cfg`` (any object
    with the reference's fields; ``use_flash`` is dropped, ``dtype`` is
    mapped by name)."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(TransformerConfig)
              if f.name != "dtype" and hasattr(cfg, f.name)}
    return TransformerConfig(**fields,
                             dtype=getattr(torch, np.dtype(cfg.dtype).name))


def _put(param, a, transpose=False) -> None:
    a = np.array(a, np.float32)
    with torch.no_grad():
        param.copy_(torch.from_numpy(a.T.copy() if transpose else a))


def transformer_params_from_numpy(tree, cfg: TransformerConfig,
                                  device="cpu") -> Transformer:
    """The port's model holding the reference's parameters.

    ``tree`` is the reference's ``transformer_init`` pytree with numpy
    leaves.  The leading scan axis is unstacked into one block per layer,
    ``(local, global)`` pairs into consecutive layers; each dense kernel
    (in, out) becomes the port's ``weight`` (out, in), rounded to bf16 as
    every use rounds it; norm scales stay f32, the embedding takes
    ``cfg.dtype``.
    """
    model = Transformer(cfg, device=device)
    _put(model.embed, tree["embed"]["table"])
    _put(model.ln_final.scale, tree["ln_final"]["scale"])
    for i, blk in enumerate(model.layers):
        if cfg.local_global:
            p = tree["layers"]["local" if i % 2 == 0 else "global"]
            step = i // 2
        else:
            p, step = tree["layers"], i
        _put(blk.ln_attn.scale, p["ln_attn"]["scale"][step])
        _put(blk.ln_ffn.scale, p["ln_ffn"]["scale"][step])
        for name in ("wq", "wk", "wv", "wo"):
            _put(getattr(blk.attn, name).weight,
                 p["attn"][name]["kernel"][step], transpose=True)
        if cfg.qk_norm:
            _put(blk.attn.q_norm.scale, p["attn"]["q_norm"]["scale"][step])
            _put(blk.attn.k_norm.scale, p["attn"]["k_norm"]["scale"][step])
        for name in ("wi", "wg", "wo"):
            _put(getattr(blk.ffn, name).weight,
                 p["ffn"][name]["kernel"][step], transpose=True)
    return model


def _put_mlp(mlp: MLP, tree) -> None:
    for i, layer in enumerate(mlp.layers):
        _put(layer.weight, tree[f"l{i}"]["kernel"], transpose=True)


def dlrm_params_from_numpy(tree, cfg: DLRMConfig, device="cpu") -> DLRM:
    """The port's DLRM holding the reference's ``dlrm_init`` pytree (numpy
    leaves): MLP kernels transposed to (out, in) and rounded to bf16, the
    26 f32 tables stacked into one bf16 (T, R, D) tensor, as every
    reference lookup rounds them."""
    model = DLRM(cfg, device=device)
    _put_mlp(model.bot, tree["bot"])
    _put_mlp(model.top, tree["top"])
    for t in range(cfg.n_sparse):
        _put(model.tables[t], tree["tables"][f"t{t}"]["table"])
    return model


def sage_params_from_numpy(tree, cfg: SAGEConfig, device="cpu") -> SAGE:
    """The port's GraphSAGE holding the reference's ``sage_init`` pytree."""
    model = SAGE(cfg, device=device)
    for l in range(cfg.n_layers):
        _put(model.self_[l].weight, tree[f"self{l}"]["kernel"], transpose=True)
        _put(model.neigh[l].weight, tree[f"neigh{l}"]["kernel"],
             transpose=True)
    _put(model.head.weight, tree["head"]["kernel"], transpose=True)
    return model


def graph_batch_from_numpy(gb, device="cpu") -> GraphBatch:
    """A `GraphBatch` with the arrays of ``gb`` (any object with the
    reference's `GraphBatch` fields; each converted with ``np.asarray``)."""
    def up(a):
        return None if a is None else torch.as_tensor(np.array(a)).to(device)

    return GraphBatch(x=up(gb.x), edge_src=up(gb.edge_src),
                      edge_dst=up(gb.edge_dst), edge_mask=up(gb.edge_mask),
                      node_mask=up(gb.node_mask), graph_ids=up(gb.graph_ids),
                      n_graphs=int(gb.n_graphs), targets=up(gb.targets),
                      pos=up(gb.pos))
