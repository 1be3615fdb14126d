"""Environment-knob parsing for the serve stack's seeded harnesses; the
port's copy of ``repro/serve/_env.py``.

Every seeded harness (chaos, SDC) reads its episode counts and base seeds
from environment variables; this module is the one place that parsing
lives, so the error messages cannot drift between copies.
"""

from __future__ import annotations

import os


def env_int(name: str, default: int) -> int:
    """Parse an integer knob from the environment, rejecting garbage with
    an actionable message instead of a bare int() traceback."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw.strip(), 10)
    except ValueError:
        raise ValueError(
            f"environment variable {name}={raw!r} is not an integer "
            f"(expected e.g. {name}={default})"
        ) from None
