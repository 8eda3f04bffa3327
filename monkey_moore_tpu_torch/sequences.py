"""Named custom-character-sequence store.

The PyTorch port's copy of the JAX package's ``sequences.py``
(``tests/test_torch_frontends.py`` holds it equal to the original).

Mirror of the reference's sequence management: named sequences (e.g. Kana
orderings) persisted to XML, with factory defaults for Hiragana and Katakana
(``src/gui/constants.hpp:48-49`` ``MM_DEFAULT_HIRAGANA``/``MM_DEFAULT_KATAKANA``;
persistence ``src/gui/monkey_prefs.cpp:183-217`` ``saveSequences`` writing
``<monkey-moore-sequences><sequence name=...>...</sequence>``).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Tuple, Union

__all__ = [
    "DEFAULT_HIRAGANA",
    "DEFAULT_KATAKANA",
    "SequenceStore",
]

# ``constants.hpp:48``
DEFAULT_HIRAGANA = (
    "あいうえおかきくけこ"
    "さしすせそたちつてと"
    "なにぬねのはひふへほ"
    "まみむめもやゆよらり"
    "るれろわをゃっゅょ"
)
# ``constants.hpp:49``
DEFAULT_KATAKANA = (
    "アイウエオカキクケコ"
    "サシスセソタチツテト"
    "ナニヌネノハヒフヘホ"
    "マミムメモヤユヨラリ"
    "ルレロワヲャッュョ"
)

_ROOT_TAG = "monkey-moore-sequences"


class SequenceStore:
    """Ordered name → sequence mapping with XML round-trip."""

    def __init__(self):
        self._items: List[Tuple[str, str]] = []
        self.reset_defaults()

    def reset_defaults(self) -> None:
        """Factory defaults (``monkey_prefs.cpp:184-188``)."""
        self._items = [
            ("Default Hiragana sequence", DEFAULT_HIRAGANA),
            ("Default Katakana sequence", DEFAULT_KATAKANA),
        ]

    def names(self) -> List[str]:
        return [name for name, _ in self._items]

    def items(self) -> List[Tuple[str, str]]:
        return list(self._items)

    def get(self, name: str) -> str:
        for n, seq in self._items:
            if n == name:
                return seq
        raise KeyError(name)

    def add(self, name: str, sequence: str) -> None:
        for i, (n, _) in enumerate(self._items):
            if n == name:
                self._items[i] = (name, sequence)
                return
        self._items.append((name, sequence))

    def remove(self, name: str) -> None:
        self._items = [(n, s) for n, s in self._items if n != name]

    # ------------------------------------------------------------------
    def save(self, path: Union[str, Path]) -> None:
        root = ET.Element(_ROOT_TAG)
        for name, seq in self._items:
            elem = ET.SubElement(root, "sequence", {"name": name})
            elem.text = seq
        tree = ET.ElementTree(root)
        ET.indent(tree)
        tree.write(path, encoding="utf-8", xml_declaration=True)

    def load(self, path: Union[str, Path]) -> None:
        """Load from XML; on parse failure keeps current items (the
        reference silently ignores unreadable sequence files,
        ``monkey_prefs.cpp:97-103``)."""
        try:
            root = ET.parse(path).getroot()
        except (ET.ParseError, OSError):
            return
        if root.tag != _ROOT_TAG:
            return
        items = []
        for elem in root.findall("sequence"):
            name = elem.get("name")
            if name is not None:
                items.append((name, elem.text or ""))
        if items:
            self._items = items
