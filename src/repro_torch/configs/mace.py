"""mace [arXiv:2206.07697]: 2L d_hidden=128 l_max=2 correlation=3 n_rbf=8
E(3)-equivariant ACE higher-order message passing."""
from ..models.gnn.mace import MACEConfig

ARCH_ID = "mace"
FAMILY = "gnn"
NEEDS_GEOMETRY = True


def make_config(**kw):
    return MACEConfig(
        name=ARCH_ID, n_layers=2, d_hidden=128, l_max=2, correlation=3,
        n_rbf=8, **kw,
    )


def smoke_config(**kw):
    return MACEConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_hidden=8, l_max=2,
        correlation=3, n_rbf=4, n_species=5, **kw,
    )
