"""schnet [gnn] — 3 interactions, d_hidden=64, 300 RBF, cutoff 10
(arXiv:1706.08566; paper)."""
from ..device import resolve_device
from ..models.gnn.schnet import SchNetConfig, schnet_init, schnet_loss
from .gnn_arch import GNNArch


def _build(meta):
    small = meta["d_feat"] <= 8
    cfg = SchNetConfig(
        d_in=meta["d_feat"],
        d_hidden=64 if not small else 16,
        n_interactions=3,
        n_rbf=300 if not small else 20,
        cutoff=10.0,
        graph_level=meta["graph_level"],
        n_out=1 if meta["graph_level"] or meta["n_out"] == 1 else meta["n_out"],
    )
    return cfg, (lambda generator, device="cuda", train=False: schnet_init(
        cfg, generator, device=resolve_device(device), train=train)), \
        schnet_loss


ARCH = GNNArch("schnet", _build, needs_positions=True)
