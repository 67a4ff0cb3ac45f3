"""Env-filtered logging + progress reporting.

The reference uses pretty_env_logger filtered by RUST_LOG plus indicatif
progress bars (reference src/render.rs:16-18, examples/
render_from_file.rs:7). Here: stdlib logging filtered by CURRY_LOG
(e.g. CURRY_LOG=debug) and a dependency-free progress bar.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from contextlib import contextmanager

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("CURRY_LOG", "info").upper()
        logging.basicConfig(
            level=getattr(logging, level, logging.INFO),
            format="%(levelname).1s %(name)s: %(message)s",
        )
        _CONFIGURED = True
    return logging.getLogger(name)


@contextmanager
def progress(total: int, enabled: bool = True, width: int = 40):
    """`with progress(n) as tick: ... tick()` — renders a bar with ETA."""
    state = {"done": 0, "t0": time.time(), "last": 0.0}

    def tick(n: int = 1):
        state["done"] += n
        now = time.time()
        if not enabled or not sys.stderr.isatty():
            return
        if now - state["last"] < 0.1 and state["done"] < total:
            return
        state["last"] = now
        frac = state["done"] / max(total, 1)
        filled = int(width * frac)
        elapsed = now - state["t0"]
        eta = elapsed / max(frac, 1e-9) * (1 - frac)
        sys.stderr.write(
            "\r[%s%s] %3d%% (eta %s)"
            % ("#" * filled, "-" * (width - filled), int(frac * 100), _fmt_t(eta))
        )
        sys.stderr.flush()

    try:
        yield tick
    finally:
        if enabled and sys.stderr.isatty():
            sys.stderr.write("\r" + " " * (width + 20) + "\r")
            sys.stderr.flush()


def _fmt_t(s: float) -> str:
    s = int(s)
    if s >= 3600:
        return f"{s//3600}h{(s%3600)//60:02d}m"
    if s >= 60:
        return f"{s//60}m{s%60:02d}s"
    return f"{s}s"
