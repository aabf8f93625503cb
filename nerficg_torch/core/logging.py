"""Leveled console logger with tqdm-compatible progress output.

Port of nerficg_tpu/core/logging.py (reference: src/Logging.py).
"""

from __future__ import annotations

import sys
from typing import Iterable

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover - tqdm is expected in the image
    tqdm = None

__all__ = ['Logger']

_COLORS = {
    'ERROR': '\033[1;31m',
    'WARNING': '\033[1;33m',
    'INFO': '\033[1;32m',
    'DEBUG': '\033[1;35m',
    'RESET': '\033[0m',
}


class Logger:
    """Static leveled logger (reference: src/Logging.py:9-51)."""

    SILENT, NORMAL, VERBOSE, DEBUG = 0, 1, 2, 3
    level: int = NORMAL
    _use_color: bool = sys.stderr.isatty()

    @classmethod
    def set_level(cls, level: int | str) -> None:
        if isinstance(level, str):
            level = {'SILENT': cls.SILENT, 'NORMAL': cls.NORMAL,
                     'VERBOSE': cls.VERBOSE, 'DEBUG': cls.DEBUG}[level.upper()]
        cls.level = level

    @classmethod
    def _write(cls, prefix: str, message: str) -> None:
        if cls._use_color:
            text = f'{_COLORS[prefix]}{prefix}{_COLORS["RESET"]}: {message}'
        else:
            text = f'{prefix}: {message}'
        if tqdm is not None:
            tqdm.write(text, file=sys.stderr)
        else:
            print(text, file=sys.stderr)

    @classmethod
    def error(cls, message: str) -> None:
        if cls.level > cls.SILENT:
            cls._write('ERROR', str(message))

    @classmethod
    def warning(cls, message: str) -> None:
        if cls.level > cls.SILENT:
            cls._write('WARNING', str(message))

    @classmethod
    def info(cls, message: str) -> None:
        if cls.level >= cls.NORMAL:
            cls._write('INFO', str(message))

    @classmethod
    def verbose(cls, message: str) -> None:
        if cls.level >= cls.VERBOSE:
            cls._write('INFO', str(message))

    @classmethod
    def debug(cls, message: str) -> None:
        if cls.level >= cls.DEBUG:
            cls._write('DEBUG', str(message))

    @classmethod
    def progress(cls, iterable: Iterable, desc: str = '', leave: bool = False,
                 total: int | None = None):
        """tqdm-wrapped progress iterator (reference: Logging.py:41)."""
        if cls.level <= cls.SILENT or tqdm is None:
            return iterable
        return tqdm(iterable, desc=desc, leave=leave, total=total,
                    file=sys.stderr, dynamic_ncols=True)
