"""Tiny shared atomic JSON-file store (tile cache, DSE sweep cache).

Load is defensive (missing/corrupt files read as empty); writes go through
tmp + rename so readers never see a torn file.
"""

from __future__ import annotations

import json
import os
import tempfile


def load_json_dict(path: str) -> dict:
    """The file's dict contents, or {} on any read/parse problem."""
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, json.JSONDecodeError):
        return {}


def atomic_write_json(path: str, data: dict) -> None:
    """Write atomically (tmp + rename); creates parent dirs.  Raises OSError
    on failure after cleaning up the tmp file — callers decide whether the
    store is best-effort."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
