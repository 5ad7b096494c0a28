"""two-tower-retrieval [Yi et al., RecSys'19]: embed_dim=256 tower MLP
1024-512-256, dot interaction, sampled softmax with logQ correction."""
from ..models.recsys import TwoTowerConfig

ARCH_ID = "two-tower-retrieval"
FAMILY = "recsys"


def make_config(**kw):
    return TwoTowerConfig(
        name=ARCH_ID, embed_dim=256, tower_mlp=(1024, 512, 256),
        n_user_fields=8, bag_len=16, user_vocab=2_000_000,
        item_vocab=2_000_000, n_dense=13, **kw,
    )


def smoke_config(**kw):
    return TwoTowerConfig(
        name=ARCH_ID + "-smoke", embed_dim=16, tower_mlp=(32, 16),
        n_user_fields=3, bag_len=4, user_vocab=500, item_vocab=500,
        n_dense=5, **kw,
    )
