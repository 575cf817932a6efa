"""graphcast [gnn] — 16-layer encoder-processor-decoder mesh GNN,
d_hidden=512, mesh_refinement=6, sum aggregator, n_vars=227
(arXiv:2212.12794; unverified)."""
import torch

from ..device import resolve_device
from ..models.gnn.common import GraphBatch, node_regression_loss
from ..models.gnn.graphcast import (
    GraphCast, GraphCastConfig, graphcast_apply, graphcast_init,
)
from .gnn_arch import GNNArch


def graphcast_loss(model: GraphCast, gb: GraphBatch) -> torch.Tensor:
    """The node regression onto a target column broadcast over the
    ``n_vars`` outputs: class ids, scalars or per-graph values (gathered
    per node), as the reference's config does for the generic shapes."""
    pred = graphcast_apply(model, gb)
    tgt = gb.targets
    if tgt.dim() == 1 and tgt.shape[0] != pred.shape[0]:
        tgt = tgt[gb.graph_ids.long()]          # per-graph → per-node
    if tgt.dim() == 1:
        tgt = tgt.float()[:, None].expand(pred.shape)
    return node_regression_loss(pred, tgt, gb.node_mask)


def _build(meta):
    small = meta["d_feat"] <= 8
    cfg = GraphCastConfig(
        d_in=meta["d_feat"],
        d_hidden=512 if not small else 16,
        n_layers=16 if not small else 2,
        n_vars=227 if not small else 4,
        mesh_refinement=6,
    )
    return cfg, (lambda generator, device="cuda", train=False: graphcast_init(
        cfg, generator, device=resolve_device(device), train=train)), \
        graphcast_loss


ARCH = GNNArch("graphcast", _build, needs_positions=False)
