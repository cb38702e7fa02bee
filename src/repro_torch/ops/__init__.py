"""repro_torch.ops — the operator API of the integer datapath.

:class:`RequantSpec` / :class:`QuantLinearParams` (``ops.spec``), the
paged-pool utilities (``ops.paged``) and the :class:`OpSet` dispatch
handle with its two backends, ``"cuda"`` and ``"torch_ref"``
(``ops.registry``, ``ops.backends``).
"""
from __future__ import annotations

from repro_torch.ops.registry import (DEFAULT_BACKEND, OP_NAMES, OpSet,
                                      available_backends, get_backend,
                                      resolve_ops)
from repro_torch.ops.spec import (PER_CHANNEL, PER_TENSOR, RAW,
                                  QuantLinearParams, RequantSpec)

__all__ = ["DEFAULT_BACKEND", "OP_NAMES", "OpSet", "PER_CHANNEL",
           "PER_TENSOR", "QuantLinearParams", "RAW", "RequantSpec",
           "available_backends", "get_backend", "resolve_ops"]
