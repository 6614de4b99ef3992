"""The trip counts of loops that run their body once on the meta device.

A dry run (``launch/dryrun.py``) counts what a step dispatches; a time
loop of thousands of steps is run there once and counted as its body times
its trip count, as the JAX package's HLO census counts a ``while``.
``loop(name, trips)`` says so to the innermost counter that registered
itself with ``counting`` (``roofline.census.Census`` does, while it is
entered); with none registered it does nothing. The models call ``loop``
(through ``models.layers.meta_scan``) and know nothing of the census.
"""
from __future__ import annotations

import contextlib

_counters: list = []


@contextlib.contextmanager
def counting(counter):
    """Register ``counter``, whose ``loop(name, trips)`` is a context
    manager, as the innermost counter while the block runs."""
    _counters.append(counter)
    try:
        yield
    finally:
        _counters.remove(counter)


@contextlib.contextmanager
def loop(name: str, trips: int):
    """What runs inside counts ``trips`` times in the innermost counter;
    nothing without one."""
    if not _counters:
        yield
        return
    with _counters[-1].loop(name, trips):
        yield
