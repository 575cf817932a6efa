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
  * the distributed plane's carried state —
    `super_block_state_from_numpy` / `super_block_state_to_numpy`: the
    reference's ``SuperBlockState`` ↔ the port's, the words viewed as
    uint32;
  * transformer weights — `transformer_params_from_numpy` builds the port's
    model from the reference's parameter pytree, and
    `transformer_config_from` its config from the reference's;
  * DLRM and GNN weights — `dlrm_params_from_numpy`,
    `sage_params_from_numpy`, `schnet_params_from_numpy`,
    `nequip_params_from_numpy`, `graphcast_params_from_numpy` (each as
    frozen serving weights, or with ``train=True`` as the reference's f32
    masters), and back into the reference's pytree: `params_to_numpy`;
  * optimizer state — `adamw_state_from_numpy` / `adamw_state_to_numpy`:
    the reference's ``AdamWState`` ↔ the port's, moments by parameter;
  * graph batches — `graph_batch_from_numpy` (from any object with the
    reference's `GraphBatch` fields).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.distributed import SuperBlockState
from .core.graph import DataGraph
from .core.plan import _TENSOR_FIELDS, PatternPlan, plan_from_numpy
from .models.common import for_serving
from .models.dlrm import DLRM, DLRMConfig
from .models.gnn.common import MLP, GraphBatch
from .models.gnn.graphcast import GraphCast, GraphCastConfig
from .models.gnn.graphsage import SAGE, SAGEConfig
from .models.gnn.nequip import NequIP, NequIPConfig
from .models.gnn.schnet import SchNet, SchNetConfig
from .models.transformer import Transformer, TransformerConfig
from .train.optimizer import AdamWState

__all__ = ["data_graph_from_arrays", "plan_from_numpy", "plan_from_fields",
           "bitmap_from_uint32", "bitmap_to_uint32", "table_from_numpy",
           "table_to_numpy", "super_block_state_from_numpy",
           "super_block_state_to_numpy", "transformer_config_from",
           "transformer_params_from_numpy", "dlrm_params_from_numpy",
           "sage_params_from_numpy", "schnet_params_from_numpy",
           "nequip_params_from_numpy", "graphcast_params_from_numpy",
           "graph_batch_from_numpy",
           "param_entries", "params_to_numpy", "adamw_state_from_numpy",
           "adamw_state_to_numpy"]


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


_SUPER_HOST_FIELDS = ("next_block", "found", "overflowed", "blocks_run",
                      "super_blocks_run", "dispatches", "max_count")


def super_block_state_from_numpy(ss, device="cpu") -> SuperBlockState:
    """The port's `SuperBlockState` from any object with the reference's
    fields (its bitmaps uint32 words, its counts int32)."""
    host = {f: getattr(ss, f) for f in _SUPER_HOST_FIELDS}
    for f in ("found", "overflowed", "blocks_run", "max_count"):
        if host[f] is not None:
            host[f] = np.array(host[f])
    return SuperBlockState(
        bitmaps=bitmap_from_uint32(ss.bitmaps, device),
        counts=torch.as_tensor(np.asarray(ss.counts, np.int32)).to(device),
        **host)


def super_block_state_to_numpy(ss: SuperBlockState) -> dict:
    """The reference's ``SuperBlockState`` fields of a port state (numpy;
    ``SuperBlockState(**super_block_state_to_numpy(ss))`` on the
    reference's side)."""
    out = {f: getattr(ss, f) for f in _SUPER_HOST_FIELDS}
    out["bitmaps"] = bitmap_to_uint32(torch.as_tensor(ss.bitmaps))
    out["counts"] = torch.as_tensor(ss.counts).cpu().numpy().astype(np.int32)
    return out


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


def _put(param, a) -> None:
    """Copy ``a`` into ``param`` (an f32 master: unchanged)."""
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(a, np.float32)))


# A parameter's entry: (port name, path in the reference's pytree, index
# on the stacked layer axis or None, transposed).  The reference stores a
# dense kernel as (in, out), the port as (out, in); DLRM's 26 tables are
# one (T, R, D) stack in the port (the path names the tables' dict).

def _transformer_entries(cfg: TransformerConfig):
    out = [("embed", ("embed", "table"), None, False),
           ("ln_final.scale", ("ln_final", "scale"), None, False)]
    for i in range(cfg.n_layers):
        if cfg.local_global:
            base, step = ("layers", "local" if i % 2 == 0 else "global"), i // 2
        else:
            base, step = ("layers",), i
        pre = f"layers.{i}."
        out += [(pre + "ln_attn.scale", base + ("ln_attn", "scale"), step,
                 False),
                (pre + "ln_ffn.scale", base + ("ln_ffn", "scale"), step,
                 False)]
        out += [(pre + f"attn.{n}.weight", base + ("attn", n, "kernel"), step,
                 True) for n in ("wq", "wk", "wv", "wo")]
        if cfg.qk_norm:
            out += [(pre + f"attn.{n}.scale", base + ("attn", n, "scale"),
                     step, False) for n in ("q_norm", "k_norm")]
        if cfg.n_experts:
            out += [(pre + "moe.router", base + ("moe", "router", "kernel"),
                     step, False)]
            out += [(pre + f"moe.{n}", base + ("moe", n), step, False)
                    for n in ("wi", "wg", "wo")]
        else:
            out += [(pre + f"ffn.{n}.weight", base + ("ffn", n, "kernel"),
                     step, True) for n in ("wi", "wg", "wo")]
    return out


def _mlp_entries(prefix: str, n_layers: int):
    return [(f"{prefix}.layers.{i}.weight", (prefix, f"l{i}", "kernel"), None,
             True) for i in range(n_layers)]


def _dlrm_entries(cfg: DLRMConfig):
    return (_mlp_entries("bot", len(cfg.bot_mlp))
            + [("tables", ("tables",), None, False)]
            + _mlp_entries("top", len(cfg.top_mlp)))


def _sage_entries(cfg: SAGEConfig):
    out = []
    for l in range(cfg.n_layers):
        out += [(f"self_.{l}.weight", (f"self{l}", "kernel"), None, True),
                (f"neigh.{l}.weight", (f"neigh{l}", "kernel"), None, True)]
    return out + [("head.weight", ("head", "kernel"), None, True)]


def _named_dense_entries(model):
    """SchNet, NequIP and GraphCast: each parameter is a dense weight whose
    module path is the reference's (``int0.filter.layers.1.weight`` →
    ``int0/filter/l1/kernel``), transposed.  NequIP's ``self_v`` and
    ``self_t`` too: the reference multiplies their (in, out) kernels in an
    einsum over the input channel, the port its (out, in) weights over the
    same channel (`models/gnn/nequip`)."""
    out = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[-1] != "weight":
            raise TypeError(f"{name}: not a dense weight")
        path = []
        for i, p in enumerate(parts[:-1]):
            if p == "layers":
                continue
            path.append(f"l{p}" if i and parts[i - 1] == "layers" else p)
        out.append((name, tuple(path) + ("kernel",), None, True))
    return out


def param_entries(model):
    """The reference-pytree entries of a port model's parameters."""
    if isinstance(model, Transformer):
        return _transformer_entries(model.cfg)
    if isinstance(model, DLRM):
        return _dlrm_entries(model.cfg)
    if isinstance(model, SAGE):
        return _sage_entries(model.cfg)
    if isinstance(model, (SchNet, NequIP, GraphCast)):
        return _named_dense_entries(model)
    raise TypeError(f"no reference layout for {type(model).__name__}")


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _read(tree, entry) -> np.ndarray:
    """The entry's array from the reference's pytree, in the port's layout."""
    name, path, step, transpose = entry
    node = _get(tree, path)
    if name == "tables":
        return np.stack([np.asarray(node[f"t{t}"]["table"])
                         for t in range(len(node))])
    a = np.asarray(node)
    if step is not None:
        a = a[step]
    return a.T if transpose else a


def _write(tree, entry, a: np.ndarray) -> None:
    """Write a port-layout array into a (copied) reference pytree."""
    name, path, step, transpose = entry
    if name == "tables":
        node = _get(tree, path)
        for t in range(a.shape[0]):
            node[f"t{t}"]["table"] = a[t]
        return
    a = a.T if transpose else a
    if step is None:
        _get(tree, path[:-1])[path[-1]] = a
    else:
        _get(tree, path)[step] = a


def _load(model, tree, train: bool):
    """``model`` (as built: f32 masters) holding ``tree``; `for_serving`
    unless ``train``."""
    for entry in param_entries(model):
        _put(model.get_parameter(entry[0]), _read(tree, entry))
    return model if train else for_serving(model)


def transformer_params_from_numpy(tree, cfg: TransformerConfig,
                                  device="cpu", train: bool = False
                                  ) -> Transformer:
    """The port's model holding the reference's parameters.

    ``tree`` is the reference's ``transformer_init`` pytree with numpy
    leaves.  The leading scan axis is unstacked into one block per layer,
    ``(local, global)`` pairs into consecutive layers; each dense kernel
    (in, out) becomes the port's ``weight`` (out, in); a MoE layer's
    ``router`` (D, E) and experts ``wi``, ``wg``, ``wo`` keep the
    reference's layout.  A serving model rounds the dense weights to bf16,
    as every use rounds them, and the embedding and experts to
    ``cfg.dtype``; with ``train`` they stay the reference's f32 masters.
    Norm scales and the router are f32 either way.
    """
    return _load(Transformer(cfg, device=device), tree, train)


def dlrm_params_from_numpy(tree, cfg: DLRMConfig, device="cpu",
                           train: bool = False) -> DLRM:
    """The port's DLRM holding the reference's ``dlrm_init`` pytree (numpy
    leaves): MLP kernels transposed to (out, in), the 26 f32 tables
    stacked into one (T, R, D) tensor; rounded to bf16 for serving, as
    every reference lookup rounds them, f32 masters with ``train``."""
    return _load(DLRM(cfg, device=device), tree, train)


def sage_params_from_numpy(tree, cfg: SAGEConfig, device="cpu",
                           train: bool = False) -> SAGE:
    """The port's GraphSAGE holding the reference's ``sage_init`` pytree
    (bf16 serving weights, or f32 masters with ``train``)."""
    return _load(SAGE(cfg, device=device), tree, train)


def schnet_params_from_numpy(tree, cfg: SchNetConfig, device="cpu",
                             train: bool = False) -> SchNet:
    """The port's SchNet holding the reference's ``schnet_init`` pytree
    (bf16 serving weights, or f32 masters with ``train``)."""
    return _load(SchNet(cfg, device=device), tree, train)


def nequip_params_from_numpy(tree, cfg: NequIPConfig, device="cpu",
                             train: bool = False) -> NequIP:
    """The port's NequIP holding the reference's ``nequip_init`` pytree
    (f32 either way; frozen unless ``train``)."""
    return _load(NequIP(cfg, device=device), tree, train)


def graphcast_params_from_numpy(tree, cfg: GraphCastConfig, device="cpu",
                                train: bool = False) -> GraphCast:
    """The port's GraphCast holding the reference's ``graphcast_init``
    pytree (bf16 serving weights, or f32 masters with ``train``)."""
    return _load(GraphCast(cfg, device=device), tree, train)


def params_to_numpy(model, template):
    """The port model's parameters as the reference's pytree: a copy of
    ``template`` (a reference pytree of the same model, numpy leaves) with
    every parameter written in (f32)."""
    out = _copy_tree(template)
    for entry in param_entries(model):
        _write(out, entry, model.get_parameter(entry[0]).detach().float()
               .cpu().numpy())
    return out


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def adamw_state_from_numpy(state, model, device="cpu") -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves: step, mu, nu) as the
    port's, keyed like ``train.step.trainable_params(model)``: moments in
    the parameters' dtype and layout, step int32."""
    step, mu, nu = state

    def moments(tree):
        return {entry[0]: torch.from_numpy(np.ascontiguousarray(
                    _read(tree, entry), np.float32)).to(device)
                for entry in param_entries(model)}

    return AdamWState(step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32, device=device),
                      mu=moments(mu), nu=moments(nu))


def adamw_state_to_numpy(state: AdamWState, model, template):
    """The port's `AdamWState` as the reference's (step, mu, nu) with numpy
    leaves, mu and nu shaped like ``template`` (the reference's params)."""
    def moments(tree):
        out = _copy_tree(template)
        for entry in param_entries(model):
            _write(out, entry, tree[entry[0]].detach().float().cpu().numpy())
        return out

    return (np.int32(int(state.step)), moments(state.mu), moments(state.nu))


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
