"""Progress reporting: a callable (fraction: float, message: str) -> None,
API-compatible with `demucs_tpu/utils/progress.py` (whose intra-segment
stage markers are not ported yet)."""

from __future__ import annotations

import sys
from typing import Callable

ProgressCallback = Callable[[float, str], None]


def null_progress(fraction: float, message: str) -> None:
    pass


def print_progress(fraction: float, message: str) -> None:
    print(f"[{fraction * 100:5.1f}%] {message}", file=sys.stderr)
