"""Observability: the warning that an option sends work down a slower path.

The JAX package's module also holds progress logging, the plot-progress
diagnostic and profiler helpers; only ``slow_down_warning`` is ported so
far (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

import warnings


def slow_down_warning(caller: str, option: str, suggestion: str) -> None:
    """Warn that an expensive option is enabled."""
    warnings.warn(
        f"{caller}: option <{option}> slows down training; set it to "
        f"{suggestion} unless you need it.",
        RuntimeWarning,
        stacklevel=3,
    )
