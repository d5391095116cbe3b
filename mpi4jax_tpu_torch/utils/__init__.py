"""Knobs and pytrees: the parts of the JAX package's ``utils/`` the port reads."""
