"""Small helpers shared across the port (counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

import os

__all__ = ["MXNetError", "env_flag"]

_ENV_FALSY = ("", "0", "false", "no", "off")


def env_flag(name, default="0"):
    """Boolean environment gate: False when ``name`` (or, unset, ``default``)
    is one of '', 0, false, no, off (case and whitespace ignored), True
    otherwise.  Read at each call, so a test can flip it."""
    return os.environ.get(name, default).strip().lower() not in _ENV_FALSY


class MXNetError(RuntimeError):
    """The framework's error type (``mxnet_tpu/base.py`` MXNetError); the
    serving errors derive from it."""
