"""Dataclasses of tensors: the port's stand-in for ``flax.struct``.

The JAX package threads its state as pytrees of ``flax.struct`` dataclasses.
The port keeps the same nesting as plain dataclasses whose leaves are
tensors (or numpy arrays on the host side), plus the two tree walks the
engine, the interop layer and the tests need. A leaf's key is its dotted
attribute path with a leading dot (``.l0.data``, ``.drops.queue``), the
spelling ``jax.tree_util.keystr`` gives the same leaf of the JAX state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator


class Tree:
    """Mixin for the port's tensor dataclasses: ``replace`` as in flax."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def leaves_with_keys(obj: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Yield ``(key, leaf)`` in field declaration order, depth first."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves_with_keys(getattr(obj, f.name),
                                        f"{prefix}.{f.name}")
    else:
        yield prefix, obj


def tree_map(fn: Callable, obj: Any) -> Any:
    """Rebuild ``obj`` with ``fn`` applied to every leaf."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return fn(obj)
