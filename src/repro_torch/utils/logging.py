"""Minimal structured logger (stdout, flat key=val), the counterpart of
``repro/utils/logging.py``: the same format, level and handler, under
the logger tree ``repro_torch``.

One difference: the reference hands ``get_logger("api")`` the logger
``api``, outside its ``repro`` tree, so its INFO records reach no
handler; here every name is put under ``repro_torch`` (``"api"`` is
``repro_torch.api``), so the facade's and the CLIs' records print
(ROADMAP C.21)."""
from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"
ROOT = "repro_torch"
_configured = False


class _StdoutHandler(logging.StreamHandler):
    """A stream handler on whatever ``sys.stdout`` is when a record is
    written (a redirect or a test's capture made after the first call
    included), where the reference binds the stream of its first call."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, _):
        pass


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger ``name`` under the ``repro_torch`` tree. The first call
    gives the tree's root one stdout handler at INFO that does not
    propagate, as the reference configures ``repro``."""
    global _configured
    if not _configured:
        handler = _StdoutHandler()
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
        root = logging.getLogger(ROOT)
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    if name != ROOT and not name.startswith(ROOT + "."):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
