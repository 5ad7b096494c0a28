"""Distribution plans of the port (``repro/dist``'s, over
:mod:`torch.distributed`)."""
