"""Device-side numeric operators on torch tensors.

Counterparts of :mod:`oisat_tpu.ops`: NaN is the missing-data channel and
every reduction is NaN-aware, with the JAX package's public layouts
((G, L, H, W) stacks, (H, W) fields).
"""
