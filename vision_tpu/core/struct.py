"""Frozen dataclass pytrees.

`@dataclass` makes a frozen dataclass and registers it with JAX: every field
is a pytree child unless it is declared `field(pytree_node=False)`, which
makes it static metadata (part of the treedef, so it keys jit caches).
Instances are immutable; `.replace(**changes)` returns an updated copy.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node=True, **kwargs):
    """dataclasses.field with a `pytree_node` flag (False = static)."""
    meta = dict(kwargs.pop("metadata", None) or {}, pytree_node=pytree_node)
    return dataclasses.field(metadata=meta, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get("pytree_node", True)])
    cls.replace = _replace
    return cls
