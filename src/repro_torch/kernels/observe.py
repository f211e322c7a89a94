"""The seam through which the dry run (``launch/dryrun.py``) sees a kernel
wrapper's plain version, and a custom call's redistributions, as the
compiled program would show them.

On CPU tensors a kernel wrapper runs its plain version through
``call_plain``: ``fn(*args)`` itself, unless an observer is installed
(``observing``), which then runs it and counts the whole call once, its
operands plus its outputs, as XLA counts a Pallas custom call, instead of
the plain version's intermediates. The card route never comes here.
``run_local`` (``kernels/dtensor.py``) reports each DTensor operand it
redistributes through ``note_redistribution``.
"""
from __future__ import annotations

from contextlib import contextmanager

_observer = None


def call_plain(name: str, fn, *args, like=None):
    """``fn(*args)``: kernel ``name``'s plain version; under an observer,
    as one observed call. ``like(*args)``, where given, makes empty
    outputs of the kernel's shapes and dtypes, which an observer may take
    instead of running ``fn``."""
    obs = _observer
    return fn(*args) if obs is None else obs.kernel_call(name, fn, args,
                                                         like)


def note_redistribution(where: str, before, after) -> None:
    """A custom call ``where`` moved an operand from DTensor ``before`` to
    ``after`` (told to the observer, if any)."""
    if _observer is not None:
        _observer.redistribution(where, before, after)


@contextmanager
def observing(observer):
    """Install ``observer`` (with ``kernel_call(name, fn, args, like)`` and
    ``redistribution(where, before, after)``) for the block."""
    global _observer
    old, _observer = _observer, observer
    try:
        yield observer
    finally:
        _observer = old
