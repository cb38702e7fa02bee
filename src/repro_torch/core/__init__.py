"""Integer-only numerics on torch int32 tensors (twin of ``repro.core``).

Three semantics the JAX reference relies on hold for torch int32 tensors
too, on the CPU and on the card: ``+``/``*`` wrap modulo 2^32, ``>>`` is
an arithmetic shift on negative values, and ``//`` (``torch.div(...,
rounding_mode="floor")``) floors.  The tests pin all three.
"""
