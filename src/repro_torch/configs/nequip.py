"""nequip [gnn] — 5 layers, d_hidden=32, l_max=2, 8 RBF, cutoff 5,
E(3)-equivariant tensor products (arXiv:2101.03164; paper)."""
from ..device import resolve_device
from ..models.gnn.nequip import NequIPConfig, nequip_init, nequip_loss
from .gnn_arch import GNNArch


def _build(meta):
    small = meta["d_feat"] <= 8
    cfg = NequIPConfig(
        d_in=meta["d_feat"],
        d_hidden=32 if not small else 8,
        n_layers=5 if not small else 2,
        n_rbf=8,
        cutoff=5.0,
        graph_level=meta["graph_level"],
    )
    return cfg, (lambda generator, device="cuda", train=False: nequip_init(
        cfg, generator, device=resolve_device(device), train=train)), \
        nequip_loss


ARCH = GNNArch("nequip", _build, needs_positions=True)
