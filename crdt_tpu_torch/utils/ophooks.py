"""The hook points of the op recorder (``analysis/optrace.py``).

The recorder sees aten ops and host reads through torch's own modes; the
port's collectives and hand-written kernel wrappers are marked here so
that each call is ONE event of the trace:

- :func:`kernel` wraps a kernel wrapper (K1, K2, K3, the fan-out encode):
  the call is one event with its input and output tensors, and nothing
  inside it is recorded — on the CPU the wrapper runs its plain version,
  whose ops are not the card's program;
- :func:`collective` wraps a collective of ``parallel/collectives.py``:
  the call is one event carrying the rank count, the permutation of a
  shift and the output bytes, and the aten ops inside it are recorded as
  usual. A ``primitive`` collective moves data (a shift, a reduction); a
  composite one (``all_reduce_lattice``, ``ring_round``) is built from
  primitives and prices no bytes of its own. A primitive inside another
  primitive (``psum`` calls ``preduce``) is not an event of its own;
- :func:`shift_factory` wraps ``permuter`` / ``ring_permuter``: making a
  shift (its index table's upload) is part of the shift, and every call of the
  shift it returns is a primitive ``ppermute`` event.

With no recorder active every hook is one global read and a call through.

Inside :func:`card_routes` a dispatch that picks its route by device
(``fold_kernels``: the fused folds on a CUDA state, the tree folds on a
CPU one) takes the card's route on any device, so that a trace taken on
the CPU is the card's program, its kernels run by their plain versions.
"""

from __future__ import annotations

import contextlib
import functools

_ACTIVE = None  # the recorder of the trace being taken, if any
_CARD_ROUTES = False


def active():
    """The recorder of the trace being taken, or None."""
    return _ACTIVE


def activate(recorder):
    """Install ``recorder`` (None to remove it); returns the previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, recorder
    return prev


@contextlib.contextmanager
def quiet():
    """Record nothing inside: work a check does beside the traced program
    (holding a kernel against its plain version)."""
    rec = _ACTIVE
    if rec is None:
        yield
        return
    with rec.quiet():
        yield


@contextlib.contextmanager
def card_routes():
    """Take the card's routes inside, on any device."""
    global _CARD_ROUTES
    prev, _CARD_ROUTES = _CARD_ROUTES, True
    try:
        yield
    finally:
        _CARD_ROUTES = prev


def on_card_routes() -> bool:
    """Whether :func:`card_routes` is in force."""
    return _CARD_ROUTES


def kernel(name: str):
    """Mark a hand-written kernel's wrapper: one event a call."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _ACTIVE
            if rec is None:
                return fn(*args, **kwargs)
            return rec.kernel_event(name, fn, args, kwargs)
        return call
    return wrap


def collective(name: str, primitive: bool = True, ranks=None, perm=None):
    """Mark a collective: one event a call. ``ranks(args, kwargs)`` gives
    its rank count (default the leading axis of its first tensor),
    ``perm(args, kwargs)`` a shift's ``(src, dst)`` pairs."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _ACTIVE
            if rec is None:
                return fn(*args, **kwargs)
            return rec.collective_event(name, fn, args, kwargs, primitive,
                                        None if ranks is None else ranks(args, kwargs),
                                        None if perm is None else list(perm(args, kwargs)))
        return call
    return wrap


def shift_factory(name: str):
    """Mark a function that makes ring shifts (``permuter(perm, p, ...)``):
    making one records nothing, each call of the shift is one primitive
    event with the permutation it was made for."""
    def wrap(build):
        @functools.wraps(build)
        def call(perm, *args, **kwargs):
            rec = _ACTIVE
            if rec is None:
                return build(perm, *args, **kwargs)
            with rec.quiet():
                move = build(perm, *args, **kwargs)
            pairs = list(perm)

            def shift(tree):
                now = _ACTIVE
                if now is None:
                    return move(tree)
                return now.collective_event(name, move, (tree,), {}, True, None, pairs)

            return shift
        return call
    return wrap


__all__ = ["activate", "active", "card_routes", "collective", "kernel", "on_card_routes",
           "quiet", "shift_factory"]
