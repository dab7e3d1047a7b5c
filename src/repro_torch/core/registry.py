"""Shared plumbing for the plugin registries.

``core/strategies.py`` (selection) and ``core/topology.py`` (federation
topology) each keep a name -> plugin dict with the same lookup
contract: an unknown name fails with an error that *lists the
registered names*.  The wording is the reference's, word for word.
"""
from __future__ import annotations

from typing import Iterable


def unknown_name_message(kind: str, name: str,
                         registered: Iterable[str]) -> str:
    """The uniform unknown-plugin error message: ``unknown <kind>
    '<name>'; registered: a, b, c``."""
    return (f"unknown {kind} {name!r}; registered: "
            f"{', '.join(sorted(registered))}")


class NotPortedError(NotImplementedError):
    """A feature of the reference package that the port does not have
    yet; raised instead of running without it."""
