"""Frozen dataclasses registered as JAX pytrees.

``@pytree_dataclass`` makes a frozen dataclass whose fields are pytree
children, except fields declared with ``static_field()``: those are
treedef metadata (hashable Python values that jit treats as static).
Instances get ``.replace(**changes)``.
"""
from __future__ import annotations

import dataclasses

import jax


def static_field(default=None):
    """A field carried in the treedef instead of as a leaf."""
    return dataclasses.field(default=default, metadata={"static": True})


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
