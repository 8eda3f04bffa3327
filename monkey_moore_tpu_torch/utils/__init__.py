from .text import (
    find_last_index,
    count_prefix_length,
    is_ascii_upper,
    is_ascii_lower,
    is_ascii_digit,
    to_codepoints,
)
from .encoding import to_utf8, codepoint_to_str
from .memory import align_up
from .logging import log, enable_logging, logging_enabled

__all__ = [
    "find_last_index",
    "count_prefix_length",
    "is_ascii_upper",
    "is_ascii_lower",
    "is_ascii_digit",
    "to_codepoints",
    "to_utf8",
    "codepoint_to_str",
    "align_up",
    "log",
    "enable_logging",
    "logging_enabled",
]
