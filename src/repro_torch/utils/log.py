"""Logging setup shared by the launchers and the training loop."""
from __future__ import annotations

import logging
import sys

_CONFIGURED = False


def get_logger(name: str = "repro_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        root = logging.getLogger("repro_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        _CONFIGURED = True
    return logging.getLogger(name)
