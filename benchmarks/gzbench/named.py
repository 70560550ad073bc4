"""The loader of the harness's files found by name: a record kind
(`kinds/<kind>.py`), a query kind (`queries/<kind>.py`), a control
(`controls/<name>.py`) and a per-layer metric's reader
(`layer_metrics/<name>.py`).  A new deployment, mix, control or metric is
a new file, and no file of the harness is edited for it.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def load(directory: Path, name: str, what: str):
    """The module `directory/<name>.py`, run anew; ValueError naming the
    file it looked for where there is none (`what` says what was asked)."""
    path = Path(directory) / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {what} {name!r}: {path} is not a file")
    spec = importlib.util.spec_from_file_location(
        re.sub(r"\W", "_", f"{Path(directory).name}_{name}"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
