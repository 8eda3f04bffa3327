"""API-level input validation.

The PyTorch port's copy of the JAX package's ``validate.py``
(``tests/test_torch_frontends.py`` holds it equal to the original).

Port of the GUI's keyword/wildcard/value-scan validation rules
(``src/gui/monkey_frame.cpp:1027-1138`` ``CheckKeyword``; warning texts from
``src/gui/constants.hpp:30-46``).  The reference enforces these at the UI
layer, not in the core engine — same here: the engine accepts anything the
core accepts, while the CLI (and any embedding application) validates via
this module.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence, Tuple, Union

from .utils.text import is_ascii_lower, is_ascii_upper, to_codepoints

__all__ = [
    "ValidationError",
    "Warning_",
    "check_keyword",
    "check_wildcard_field",
    "parse_value_scan",
]


class Warning_(enum.Enum):
    """Mirror of the warning identifiers in ``constants.hpp:30-46``."""

    KWORDSIZE = "You must input a keyword with 3 or more characters."
    KWORDCAPLETTERS = (
        "The keyword must have at least 3 upper or lower characters."
    )
    KWORDLETTERS = (
        "The keyword must have at least 3 letters, excluding wildcards."
    )
    KWORDINVALIDCHARS = (
        "Only letters and wildcards are supported. "
        "You may not use any other characters."
    )
    KWORDNONWILDCARD = "You must input 3 or more non-wildcard characters."
    KWORDCPMISMATCH = (
        "You must input a keyword containing ONLY characters found in your "
        "defined charset."
    )
    VSRINVALIDVAL = (
        "Invalid value found. You should input only non-negative decimal "
        "numbers."
    )
    CHARPATWILDCARD = (
        "You cannot use the defined wildcard character in your custom charset."
    )
    CHARPATDUPLICATED = (
        "The defined character set may not contain duplicated characters."
    )
    NOWC = (
        "The wildcard option is enabled. "
        "You must input the desired wildcard in the field."
    )
    MANYWC = (
        "Only one character should be used as wildcard. "
        "Remove extra characters."
    )


class ValidationError(ValueError):
    def __init__(self, warning: Warning_):
        super().__init__(warning.value)
        self.warning = warning


def _is_ascii_alpha(c: int) -> bool:
    return is_ascii_lower(c) or is_ascii_upper(c)


def check_keyword(
    keyword: Union[str, Sequence[int]],
    wildcard: Union[str, int, None] = "*",
    char_seq: Union[str, Sequence[int], None] = (),
) -> Optional[Warning_]:
    """Validate a relative-search keyword; returns the warning or None.

    Parity: ``CheckKeyword`` (``monkey_frame.cpp:1027-1138``).
    """
    kw = to_codepoints(keyword)
    seq = to_codepoints(char_seq)
    wc = (
        0
        if wildcard in (None, "")
        else (ord(wildcard) if isinstance(wildcard, str) else int(wildcard))
    )

    custom_cp = len(seq) != 0
    # printable-ASCII probe (``:1033-1036``: nothing below 0x20, above 0x7A)
    ascii_input = all(0x20 <= c <= 0x7A for c in kw)
    n_wildcards = sum(1 for c in kw if c == wc)

    if len(kw) < 3:
        return Warning_.KWORDSIZE

    if not custom_cp and ascii_input:
        n_lower = sum(1 for c in kw if is_ascii_lower(c))
        n_upper = sum(1 for c in kw if is_ascii_upper(c))
        if n_lower and n_upper:
            if n_lower < 3 and n_upper < 3:
                return Warning_.KWORDCAPLETTERS
        else:
            n_letters = sum(1 for c in kw if _is_ascii_alpha(c))
            if n_letters < 3:
                return Warning_.KWORDLETTERS
        non_alpha = sum(1 for c in kw if not _is_ascii_alpha(c))
        if non_alpha > n_wildcards:
            return Warning_.KWORDINVALIDCHARS
    else:
        if len(kw) - n_wildcards < 3:
            return Warning_.KWORDNONWILDCARD
        if custom_cp:
            if n_wildcards and wc in seq:
                return Warning_.CHARPATWILDCARD
            if len(set(seq)) != len(seq):
                return Warning_.CHARPATDUPLICATED
            kw_set = {c for c in kw if c != wc}
            if not kw_set <= set(seq):
                return Warning_.KWORDCPMISMATCH
    return None


def check_wildcard_field(
    use_wildcards: bool, field: str
) -> Optional[Warning_]:
    """Wildcard text-field rules (``monkey_frame.cpp:520-534`` paths;
    messages ``constants.hpp:43-44``)."""
    if not use_wildcards:
        return None
    if len(field) == 0:
        return Warning_.NOWC
    if len(field) > 1:
        return Warning_.MANYWC
    return None


def parse_value_scan(text: str) -> Sequence[int]:
    """Parse a value-scan input string of whitespace/comma-separated
    non-negative decimal numbers; raises :class:`ValidationError` on bad
    tokens (``constants.hpp:39``)."""
    values = []
    for token in text.replace(",", " ").split():
        if not token.isdigit():
            raise ValidationError(Warning_.VSRINVALIDVAL)
        values.append(int(token))
    if not values:
        raise ValidationError(Warning_.VSRINVALIDVAL)
    return values
