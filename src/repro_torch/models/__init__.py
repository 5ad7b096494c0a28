"""The port's model half: the decoder-only LMs (``transformer.py``, with
``moe.py``) on the shared blocks of ``common.py``, the GNNs (``gnn/``) and
the neighbor sampler (``sampler.py``)."""
