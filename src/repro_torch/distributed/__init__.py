"""Quantized collectives and tensor-parallel serving on ``torch.distributed``,
and the fault-tolerant training loop (the port of ``repro.distributed``'s
``collectives``, ``tp_serving`` and ``fault``)."""
