"""The plain reference that decides ``correct``: float64 DBSCAN and the
judgment of a fit against it, in numpy and torch primitives only.  Nothing here imports
``jax``, the JAX package ``repro`` or the port ``repro_torch``."""
