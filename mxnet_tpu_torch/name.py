"""Automatic naming (counterpart of ``mxnet_tpu/name.py``; reference
python/mxnet/name.py): ``NameManager`` gives ``<hint><n>`` names to the
symbols built inside it, ``Prefix`` puts a prefix before each."""
from __future__ import annotations

from .symbol.symbol import NameManager

__all__ = ["NameManager", "Prefix"]


class Prefix(NameManager):
    """A NameManager that puts ``prefix`` before every name it gives."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
