"""Thingy-table (.tbl) export.

The PyTorch port's copy of the JAX package's ``tables.py``
(``tests/test_torch_frontends.py`` holds it equal to the original).

Builds an editable byte⇔character table from a recovered equivalency map and
writes it as a Thingy ``.tbl`` file, mirroring the GUI's table-creator
semantics:

- 'a'/'A' entries expand into 26 consecutive letters with wraparound at the
  element type's cardinality (``src/gui/dialogs/table_creator.cpp:170-192``);
- hex keys render the element's bytes in *file order* (display byteswap,
  ``table_creator.cpp:181-187``), zero-padded to 2×element_width digits;
- lines are ``HEX=char`` joined with CRLF (``table_creator.cpp:100-108``);
- supported encodings: ANSI (ISO-8859-1; rejects non-ANSI content like the
  reference does, ``table_creator.cpp:113-114``), UTF-8, UTF-16
  (``table_creator.cpp:123-151``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

from .config import Endianness

__all__ = ["build_table_data", "format_tbl", "save_tbl"]


def _file_order_hex(value: int, element_width: int, endianness: Endianness) -> str:
    """Hex key showing the element's bytes as they appear in the file."""
    digits = element_width * 2
    if element_width > 1 and endianness is Endianness.LITTLE:
        # display byteswap: LE value 0x1234 is stored as bytes 34 12
        swapped = ((value & 0xFF) << 8) | ((value >> 8) & 0xFF)
        value = swapped
    return f"{value:0{digits}X}"


def build_table_data(
    values_map: Dict[int, int],
    element_width: int,
    endianness: Endianness = Endianness.LITTLE,
) -> Dict[str, str]:
    """Equivalency map → {hex_key: character} table (sorted by hex key, as
    the reference's ``std::map<wxString, ...>`` ordering produces)."""
    mod = 1 << (8 * element_width)
    table: Dict[str, str] = {}
    for char, value in values_map.items():
        if char in (ord("a"), ord("A")):
            counter = int(value)
            for j in range(26):
                if counter == mod:
                    counter = 0  # wraparound (``table_creator.cpp:176-177``)
                table[_file_order_hex(counter, element_width, endianness)] = chr(
                    char + j
                )
                counter += 1
        else:
            table[_file_order_hex(int(value) % mod, element_width, endianness)] = (
                chr(char)
            )
    return dict(sorted(table.items()))


def format_tbl(table: Dict[str, str]) -> str:
    """``HEX=char`` lines joined with CRLF (one trailing CRLF)."""
    return "".join(f"{k}={v}\r\n" for k, v in table.items())


def save_tbl(
    path: Union[str, Path],
    table: Dict[str, str],
    encoding: str = "utf-8",
) -> None:
    """Write the table file.  ``encoding``: 'ansi', 'utf-8' or 'utf-16'.

    Raises ValueError for non-ANSI content in ANSI mode, mirroring the
    reference's refusal (``table_creator.cpp:113-114``).
    """
    text = format_tbl(table)
    enc = encoding.lower()
    if enc == "ansi":
        try:
            blob = text.encode("iso-8859-1")
        except UnicodeEncodeError:
            raise ValueError(
                "Can't save in the specified encoding: "
                "The table contains non-ANSI characters."
            ) from None
    elif enc == "utf-8":
        blob = text.encode("utf-8")
    elif enc == "utf-16":
        blob = text.encode("utf-16")  # BOM + LE, the portable reading of
        # the reference's raw wide-char dump (``table_creator.cpp:138-140``)
    else:
        raise ValueError(f"unsupported encoding {encoding!r}")
    Path(path).write_bytes(blob)
