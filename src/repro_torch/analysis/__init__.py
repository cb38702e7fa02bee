"""Static analysis of the port's integer datapath and kernel launches
(twin of ``repro.analysis``).

  * :mod:`repro_torch.analysis.budgets`   — the bit budgets and the typed
    :class:`BitBudgetError` (``op`` / ``layer``);
  * :mod:`repro_torch.analysis.ranges`    — the :class:`IntRange` domain
    and the sound transfer functions of the integer primitives;
  * :mod:`repro_torch.analysis.interpret` — ``certify_config``, the walk
    over one config's plans, with each op's Hopper route;
  * :mod:`repro_torch.analysis.contracts` — the launch contracts of the
    H100 kernels (:func:`check_launch`, :func:`check_tp_launch`,
    :func:`require_launch`), the backends' route choice and the request
    contract;
  * :mod:`repro_torch.analysis.lint`      — the repo-rule linter
    RR001–RR004 (``python -m repro_torch.analysis.lint``);
  * :mod:`repro_torch.analysis.certify`   — the CLI certifying every
    registry config into ``docs/CERTIFY_TORCH.json``
    (``python -m repro_torch.analysis.certify``).

See docs/ANALYSIS.md for the abstract-domain contract.
"""
from repro_torch.analysis.budgets import (INT32_MAX, MAX_ROWSUM_LEN, MAX_SQ,
                                          BitBudgetError, static_check)
from repro_torch.analysis.contracts import (KernelContractError,
                                            LaunchReport, check_launch,
                                            check_tp_launch, require_launch)
from repro_torch.analysis.ranges import IntRange
