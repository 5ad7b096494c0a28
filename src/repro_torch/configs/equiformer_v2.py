"""equiformer-v2 [arXiv:2306.12059]: 12L d_hidden=128 l_max=6 m_max=2
8 heads — SO(2)-eSCN equivariant graph attention."""
from ..models.gnn.equiformer_v2 import EquiformerV2Config

ARCH_ID = "equiformer-v2"
FAMILY = "gnn"
NEEDS_GEOMETRY = True


def make_config(**kw):
    return EquiformerV2Config(
        name=ARCH_ID, n_layers=12, d_hidden=128, l_max=6, m_max=2,
        n_heads=8, **kw,
    )


def smoke_config(**kw):
    return EquiformerV2Config(
        name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16, l_max=2, m_max=2,
        n_heads=2, n_species=5, **kw,
    )
