"""Diagnostic: the one result type of the analysis layer (counterpart of
``mxnet_tpu/analysis/diagnostics.py``).

The graph analyzers report through this shape, so callers and tests treat
"a finding" uniformly.  A Diagnostic is a value, never an exception: the
caller decides whether a severity fails anything (``Executor.check`` just
returns the list).
"""
from __future__ import annotations

__all__ = ["Diagnostic", "ERROR", "WARNING", "INFO", "worst_severity"]

# severity ladder, most severe first — ordering is part of the contract
# (worst_severity / sort keys rely on it)
ERROR = "error"
WARNING = "warning"
INFO = "info"
_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


class Diagnostic:
    """One finding.

    ``code``      stable kebab-case rule id ("prng-shared-stream", ...);
    ``severity``  "error" | "warning" | "info";
    ``message``   human sentence with the specifics;
    ``where``     what it anchors to (a node or env name), or None;
    ``analyzer``  the registered analyzer that produced it, filled in by
                  the manager.
    """

    __slots__ = ("code", "severity", "message", "where", "analyzer")

    def __init__(self, code, severity, message, where=None, analyzer=None):
        if severity not in _ORDER:
            raise ValueError("severity %r not in %s"
                             % (severity, tuple(_ORDER)))
        self.code = str(code)
        self.severity = severity
        self.message = str(message)
        self.where = where
        self.analyzer = analyzer

    def _sort_key(self):
        return (_ORDER[self.severity], self.code, str(self.where))

    def __repr__(self):
        return "Diagnostic(%s, %s, %r)" % (self.code, self.severity,
                                           self.message)

    def __str__(self):
        loc = " [%s]" % (self.where,) if self.where else ""
        return "[%s] %s%s: %s" % (self.severity, self.code, loc, self.message)


def worst_severity(diagnostics):
    """The most severe level present, or None for an empty list."""
    worst = None
    for d in diagnostics:
        if worst is None or _ORDER[d.severity] < _ORDER[worst]:
            worst = d.severity
    return worst
