"""gatedgcn [arXiv:2003.00982]: 16L d_hidden=70 gated aggregation."""
from ..models.gnn.gatedgcn import GatedGCNConfig

ARCH_ID = "gatedgcn"
FAMILY = "gnn"
NEEDS_GEOMETRY = False


def make_config(d_in=1433, n_classes=7, **kw):
    return GatedGCNConfig(
        name=ARCH_ID, n_layers=16, d_hidden=70, d_in=d_in,
        n_classes=n_classes, **kw,
    )


def smoke_config(**kw):
    return GatedGCNConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_hidden=16, d_in=12,
        n_classes=4, **kw,
    )
