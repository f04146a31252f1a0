"""The sanitizer mode: raise at the first op that makes a NaN.

The port's counterpart of ``jax_debug_nans``, which the JAX package's
``EvalConfig.debug_nans`` turns on for its device program.  :func:`sanitize`
enters a ``TorchDispatchMode`` that looks at the floating outputs of every
ATen op and raises ``FloatingPointError`` naming the op when one holds a
NaN.  Only NaN raises, as in JAX: ``-inf`` is a legitimate value (the corner
detector masks its border and its non-maxima with it).  Uninitialised
buffers (``empty`` and its kin) are not looked at.

The mode cannot see a kernel launched through ``ctypes``, so the kernel
wrappers check their own outputs with :func:`check` (the error names the
wrapper) and, under the mode, run their host work inside :func:`scope`,
which names the wrapper beside an op of that work.

It costs a device synchronisation per op, so it is for debugging only.
The evaluator turns it on around its device pass when ``debug_nans`` is
set (which also turns off ``program_cache``: a graph replay runs no op the
mode could see).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["active", "check", "sanitize", "scope"]

# ops whose output is uninitialised memory or a buffer being re-pointed
_UNREAD = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
           "resize_", "set_"}

_depth = 0
_scopes: List[str] = []


def active() -> bool:
    """Whether a :func:`sanitize` block is open."""
    return _depth > 0


def _raise_on_nan(what: str, tensors) -> None:
    for t in tensors:
        if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                and bool(torch.isnan(t).any())):
            raise FloatingPointError(f"debug_nans: NaN in the output of {what}")


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNREAD:
            where = f" inside {_scopes[-1]}" if _scopes else ""
            _raise_on_nan(f"{func}{where}", tree_leaves(out))
        return out


@contextlib.contextmanager
def sanitize() -> Iterator[None]:
    """Raise ``FloatingPointError`` at the first op inside the block whose
    output holds a NaN."""
    global _depth
    _depth += 1
    try:
        with _NanCheck():
            yield
    finally:
        _depth -= 1


class _Scope:
    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        _scopes.append(self.name)

    def __exit__(self, *exc) -> None:
        _scopes.pop()


_NO_SCOPE = contextlib.nullcontext()


def scope(name: str):
    """Under :func:`sanitize`, a block whose errors name ``name`` (a kernel
    wrapper); otherwise a no-op."""
    return _Scope(name) if _depth else _NO_SCOPE


def check(name: str, *tensors: torch.Tensor) -> None:
    """Under :func:`sanitize`, raise if the outputs of ``name`` (a kernel the
    mode could not see) hold a NaN; otherwise do nothing."""
    if active():
        _raise_on_nan(name, tensors)
