"""Utilities: progress callbacks, device choice, f32 precision scope."""

from .device import f32_precision, resolve_device  # noqa: F401
from .progress import ProgressCallback, null_progress, print_progress  # noqa: F401
