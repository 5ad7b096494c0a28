"""Model configurations the port runs (``registry.get_module``)."""
