"""Attribute scopes (counterpart of ``mxnet_tpu/attribute.py``; reference
python/mxnet/attribute.py): ``with AttrScope(ctx_group="dev1"):`` gives
every symbol built inside it these user attributes, under the ones the
call names itself.  Scopes nest; the inner one wins."""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be a string")
        self._attr = kwargs
        self._old_scope = None

    def get(self, attr):
        """The scope's attributes updated by ``attr`` (a dict or None)."""
        ret = dict(self._attr)
        ret.update(attr or {})
        return ret

    def __enter__(self):
        self._old_scope = AttrScope.current()
        attr = dict(self._old_scope._attr)
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current():
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        return AttrScope._current.value
