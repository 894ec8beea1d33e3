"""A log of the calls that stand where the port launches a kernel.

Each such function is decorated with `logged(kind)`. Inside `record()`,
every call appends its arguments by name, a tensor as its shape (a tuple)
and anything else as it is, so the benchmark can count the work that a
kernel's function needs at the inputs it is given without knowing which
arguments a later reader wants.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect

import torch

_logs: list = []


@contextlib.contextmanager
def record():
    """Yield {kind: [arguments dict, ...]} filled by the calls made inside."""
    log = collections.defaultdict(list)
    _logs.append(log)
    try:
        yield log
    finally:
        _logs.remove(log)


def shape_of(value):
    return tuple(value.shape) if isinstance(value, torch.Tensor) else value


def logged(kind: str):
    """Decorate a function that stands where the port launches kernel
    `kind`: inside `record()` each call logs its arguments (`shape_of`)."""
    def wrap(fn):
        signature = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _logs:
                bound = signature.bind(*args, **kwargs)
                bound.apply_defaults()
                entry = {k: shape_of(v) for k, v in bound.arguments.items()}
                for log in _logs:
                    log[kind].append(entry)
            return fn(*args, **kwargs)
        return call
    return wrap
