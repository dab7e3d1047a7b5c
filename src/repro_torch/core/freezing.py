"""Layer-selection helpers (paper Alg. 2 line 3).

The strategies themselves live in ``core/strategies.py`` as registered
plugins; this module keeps the paper's fraction settings.
"""
from __future__ import annotations


def n_train_from_fraction(n_units: int, fraction: float) -> int:
    """The paper's 25%/50%/75% settings -> unit counts (at least 1)."""
    return max(1, round(n_units * fraction))
