"""The integer bit budgets, in one place (twin of ``repro.analysis.budgets``).

  * ``INT32_MAX``      — the accumulator container every static check
    proves against;
  * ``MAX_ROWSUM_LEN`` — longest softmax row whose exact e16 sum stays
    int32: ``rowlen * 2^15 <= 2^30``;
  * ``MAX_SKV_ONLINE`` — longest key row of the one-pass online attention
    (K8): its unnormalised int8 weights bound ``acc <= (sum_e16 >> 8) *
    127 <= L * 2^14``, int32-safe up to ``L = 2^16``;
  * ``MAX_SQ``         — speculative query rows one decode launch holds.
"""
from __future__ import annotations

INT32_MAX = 2 ** 31 - 1

MAX_ROWSUM_LEN = 1 << 15

MAX_SKV_ONLINE = 1 << 16

MAX_SQ = 8


class BitBudgetError(ValueError):
    """A worst-case integer range left its budget (a ``ValueError``).

    Fields: ``what`` (the intermediate), ``value`` (its worst case),
    ``budget`` (the bound it had to stay under), ``op`` (the ops-API op
    being certified, or None) and ``layer`` (the model-walk location,
    e.g. ``"ffn.down"``, or None); the message names both where given."""

    def __init__(self, what: str, value: int, budget: int = INT32_MAX,
                 op: str | None = None, layer: str | None = None):
        self.what = what
        self.value = int(value)
        self.budget = int(budget)
        self.op = op
        self.layer = layer
        where = "".join(
            f" [{k}={v}]" for k, v in (("op", op), ("layer", layer)) if v)
        if budget == INT32_MAX:
            msg = (f"int32 overflow in {what}: worst case {value} > "
                   f"2^31-1{where}")
        else:
            msg = f"budget exceeded in {what}: {value} > {budget}{where}"
        super().__init__(msg)


def static_check(val: int, what: str, budget: int = INT32_MAX,
                 op: str | None = None, layer: str | None = None) -> int:
    """Design-time bound check; returns ``val`` so checks can inline."""
    if val > budget:
        raise BitBudgetError(what, val, budget, op=op, layer=layer)
    return val


def bits_for(v: int) -> int:
    """Bits needed for magnitude ``v`` (pure-Python twin of
    ``core.dyadic.bits_for``, kept here so this module stays a leaf)."""
    v = int(v)
    return 0 if v <= 0 else v.bit_length()
