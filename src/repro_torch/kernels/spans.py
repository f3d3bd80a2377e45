"""Kernel spans: which ops of a traced call run inside a kernel.

Each kernel wrapper marks its call as a span (:func:`marks_span`), on the
card and on its plain branch alike, and the lowering marks its plain calls
of the same kernels the same way (``impl="torch"`` calls ``kernels/ref.py``
directly).  ``analysis/trace_audit.py`` listens (:func:`listening`) while
it traces a lowered chain with a ``TorchDispatchMode``: an op dispatched
inside a span belongs to that kernel pass (the plain versions' fp32
upcasts, say), one outside it is glue between passes.  With no listener a
span costs one global read.
"""
from __future__ import annotations

import contextlib
import functools

#: The audit listening: an object with ``enter(name)`` and ``exit()``.
_listener = None


class span:
    """``with span(name):`` marks the ops inside as one kernel pass."""

    __slots__ = ("name", "listener")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.listener = _listener
        if self.listener is not None:
            self.listener.enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.listener is not None:
            self.listener.exit()
        return False


def marks_span(name: str):
    """Decorator: the wrapped kernel wrapper's calls are spans."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _listener is None:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


@contextlib.contextmanager
def listening(listener):
    """Route every span to ``listener`` while the block runs."""
    global _listener
    prev, _listener = _listener, listener
    try:
        yield listener
    finally:
        _listener = prev
