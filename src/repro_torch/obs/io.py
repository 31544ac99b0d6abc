"""Atomic artifact writes (temp file + ``os.replace``).

Counterpart of ``repro.obs.io``, unchanged: the module is
host-side Python with no device code.

Every observability artifact — the PlanCacheStats dump, the Chrome
trace, the metrics snapshot — goes through these helpers: the bytes
land in a temp file in the TARGET directory first and are renamed into
place, so a crash mid-``drain`` can never leave truncated JSON that a
downstream benchmark reader chokes on.  ``os.replace`` is atomic on
POSIX within one filesystem, which same-directory placement guarantees.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any


def atomic_write_text(path: Any, text: str) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(p.parent), prefix=p.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return p


def atomic_write_json(path: Any, obj: Any, *, indent: int = 1,
                      sort_keys: bool = True) -> Path:
    return atomic_write_text(
        path, json.dumps(obj, indent=indent, sort_keys=sort_keys) + "\n")
