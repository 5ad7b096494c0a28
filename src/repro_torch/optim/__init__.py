"""Optimizers of the port (``optimizers.py``): functional, on the JAX
package's parameter trees."""
from .optimizers import *  # noqa: F401,F403
