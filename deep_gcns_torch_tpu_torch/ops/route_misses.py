"""The route-miss ledger shared by the op modules (counterpart of
`deep_gcns_torch_tpu/ops/segment.py:43-72`): a call whose graph lacks what
a kernel route reads (CSR/CSC auxiliaries, a band the window reduce
serves) is counted by route and reason, and logged once per reason when
its tensors are on the card."""

from __future__ import annotations

import logging
from typing import Dict

_log = logging.getLogger(__name__)

# route:reason -> number of calls that took the slow path
FASTPATH_MISSES: Dict[str, int] = {}
_warned_keys: set = set()


def miss(route: str, reason: str, *, warn: bool = False) -> bool:
    """Count that ``route`` fell off its kernel; returns False so that a gate
    can end with it. ``warn`` (the tensors are on the card) logs each
    route:reason once."""
    key = f"{route}:{reason}"
    FASTPATH_MISSES[key] = FASTPATH_MISSES.get(key, 0) + 1
    if warn and key not in _warned_keys:
        _warned_keys.add(key)
        _log.warning("kernel route disabled for %s: %s; the plain path runs instead.",
                     route, reason)
    return False


def fastpath_misses() -> Dict[str, int]:
    """A copy of the route-miss counters (route:reason -> calls). Each eager
    call counts, so a run's number grows with its steps."""
    return dict(FASTPATH_MISSES)
