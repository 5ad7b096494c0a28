"""The port's GNN models (``repro/models/gnn``): gatedgcn, meshgraphnet,
mace and equiformer-v2 on the message-passing blocks of ``common.py``,
whose segment sums run on K5 (``kernels/segment_reduce``) on the card."""
