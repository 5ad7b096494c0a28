"""The port's model half: so far the dense decoder-only LMs
(``transformer.py``) on the shared blocks of ``common.py``."""
