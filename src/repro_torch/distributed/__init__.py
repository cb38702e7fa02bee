"""Quantized collectives, tensor-parallel serving, sharding over a mesh
of ranks and the fault-tolerant training loop on ``torch.distributed``
(the port of ``repro.distributed``'s ``collectives``, ``tp_serving``,
``sharding`` and ``fault``)."""
