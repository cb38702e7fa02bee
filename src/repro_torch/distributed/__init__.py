"""Quantized collectives and tensor-parallel serving on ``torch.distributed``
(the port of ``repro.distributed``'s ``collectives`` and ``tp_serving``)."""
