"""graphsage-reddit [gnn] — 2 layers, d_hidden=128, mean aggregator,
sample sizes 25-10 (arXiv:1706.02216; paper)."""
from ..device import resolve_device
from ..models.gnn.graphsage import SAGEConfig, sage_init, sage_loss
from .gnn_arch import GNNArch


def _build(meta):
    cfg = SAGEConfig(
        d_in=meta["d_feat"],
        d_hidden=128 if meta["d_feat"] > 8 else 16,
        n_layers=2,
        n_classes=max(meta["n_out"], 1),
        aggregator="mean",
    )
    return cfg, (lambda generator, device="cuda", train=False: sage_init(
        cfg, generator, device=resolve_device(device), train=train)), (
        lambda model, gb: sage_loss(model, gb))


ARCH = GNNArch("graphsage-reddit", _build)
