"""Logging configuration.

Copy of `directdemod_tpu/utils/logsetup.py` (behavioural reference: `log.log`,
ref log.py:13-43): root logger with a DEBUG file handler (timestamped
format) and an optional INFO console handler. The port keeps its own copy
so that it loads nothing of the JAX package; its list of noisy loggers
names torch where the source names jax.
"""
from __future__ import annotations

import logging


def setup(filename: str | None = None, console: bool = True) -> None:
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if filename:
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    if console:
        ch = logging.StreamHandler()
        ch.setLevel(logging.INFO)
        ch.setFormatter(fmt)
        root.addHandler(ch)
    # keep framework-internal debug chatter out of the decode logs
    for noisy in ("torch", "matplotlib"):
        logging.getLogger(noisy).setLevel(logging.WARNING)
