"""graphsage-reddit [gnn] — 2 layers, d_hidden=128, mean aggregator,
sample sizes 25-10 (arXiv:1706.02216; paper)."""
from ..device import resolve_device
from ..models.gnn.graphsage import SAGEConfig, sage_init, sage_loss
from .gnn_arch import PORTED_SHAPES, GNNArch


def _build(meta):
    cfg = SAGEConfig(
        d_in=meta["d_feat"],
        d_hidden=128 if meta["d_feat"] > 8 else 16,
        n_layers=2,
        n_classes=max(meta["n_out"], 1),
        aggregator="mean",
        graph_level=meta["graph_level"],
    )
    return cfg, (lambda generator, device="cuda", train=False: sage_init(
        cfg, generator, device=resolve_device(device), train=train)), \
        sage_loss


# the CSR aggregate holds ogb_products' 61.9 M edges once each
ARCH = GNNArch("graphsage-reddit", _build,
               ported_shapes=PORTED_SHAPES + ("ogb_products",))
