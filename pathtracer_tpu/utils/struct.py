"""Frozen pytree dataclasses (the package's scene/camera/material records).

`@struct.dataclass` makes a frozen dataclass a JAX pytree: fields are
traced leaves unless declared `struct.field(pytree_node=False)`, which
makes them static metadata (part of the jit cache key).  `.replace(**kw)`
returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; pytree_node=False marks it static."""
    meta = dict(kwargs.pop('metadata', None) or {})
    meta['pytree_node'] = pytree_node
    return dataclasses.field(metadata=meta, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get('pytree_node', True)]
    meta = [f.name for f in fields if not f.metadata.get('pytree_node', True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls
