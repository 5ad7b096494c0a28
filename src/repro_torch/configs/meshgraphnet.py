"""meshgraphnet [arXiv:2010.03409]: 15L d_hidden=128 sum aggregation,
2-layer MLPs, encode-process-decode."""
from ..models.gnn.meshgraphnet import MeshGraphNetConfig

ARCH_ID = "meshgraphnet"
FAMILY = "gnn"
NEEDS_GEOMETRY = False


def make_config(d_node_in=8, d_edge_in=4, d_out=3, **kw):
    return MeshGraphNetConfig(
        name=ARCH_ID, n_layers=15, d_hidden=128, mlp_layers=2,
        d_node_in=d_node_in, d_edge_in=d_edge_in, d_out=d_out, **kw,
    )


def smoke_config(**kw):
    return MeshGraphNetConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16, mlp_layers=2,
        d_node_in=8, d_edge_in=4, d_out=3, **kw,
    )
