"""Internationalization.

The PyTorch port's copy of the JAX package's ``i18n.py``
(``tests/test_torch_frontends.py`` holds it equal to the original).

The reference ships gettext catalogs (``assets/i18n/original.po``,
``messages-pt_br.po``) loaded at startup (``src/gui/monkey_app.cpp:26-28``).
This module provides the same capability without a gettext build step: a
tiny ``.po``-subset reader plus a built-in pt_BR catalog covering the user
-facing warning/UI strings.  Select via ``MMTPU_LANG`` or the process locale
(``LANG``/``LC_ALL``); ``_()`` is the translation entry point.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, Optional

__all__ = ["_", "set_language", "current_language", "load_po", "CATALOGS"]

# Portuguese (Brazil) catalog for the validation warnings and common CLI
# strings — the same language the reference ships.
_PT_BR: Dict[str, str] = {
    "You must input a keyword with 3 or more characters.":
        "Você deve digitar uma palavra-chave com 3 ou mais caracteres.",
    "The keyword must have at least 3 upper or lower characters.":
        "A palavra-chave deve ter pelo menos 3 caracteres maiúsculos ou "
        "minúsculos.",
    "The keyword must have at least 3 letters, excluding wildcards.":
        "A palavra-chave deve ter pelo menos 3 letras, excluindo curingas.",
    "Only letters and wildcards are supported. You may not use any other "
    "characters.":
        "Apenas letras e curingas são suportados. Você não pode usar outros "
        "caracteres.",
    "You must input 3 or more non-wildcard characters.":
        "Você deve digitar 3 ou mais caracteres que não sejam curingas.",
    "You must input a keyword containing ONLY characters found in your "
    "defined charset.":
        "Você deve digitar uma palavra-chave contendo APENAS caracteres "
        "encontrados no seu conjunto definido.",
    "Invalid value found. You should input only non-negative decimal "
    "numbers.":
        "Valor inválido encontrado. Você deve digitar apenas números "
        "decimais não-negativos.",
    "You cannot use the defined wildcard character in your custom charset.":
        "Você não pode usar o caractere curinga definido no seu conjunto "
        "personalizado.",
    "The defined character set may not contain duplicated characters.":
        "O conjunto de caracteres definido não pode conter caracteres "
        "duplicados.",
    "The wildcard option is enabled. You must input the desired wildcard in "
    "the field.":
        "A opção de curinga está habilitada. Você deve digitar o curinga "
        "desejado no campo.",
    "Only one character should be used as wildcard. Remove extra "
    "characters.":
        "Apenas um caractere deve ser usado como curinga. Remova os "
        "caracteres extras.",
    "File not found": "Arquivo não encontrado",
    "result(s)": "resultado(s)",
    "aborted": "abortado",
    "Table saved successfully.": "Tabela salva com sucesso.",
    # strings added by this framework (no upstream-catalog counterpart)
    "unable to open {}: file not found.":
        "não foi possível abrir {}: arquivo não encontrado.",
    "no results to create a table from.":
        "nenhum resultado para criar uma tabela.",
    "no file open (use: open FILE)":
        "nenhum arquivo aberto (use: open ARQUIVO)",
}

CATALOGS: Dict[str, Dict[str, str]] = {"pt_br": _PT_BR, "pt": _PT_BR}

_active: Optional[Dict[str, str]] = None
_lang = "en"

#: vendored copy of the reference's shipped gettext catalog
#: (``assets/i18n/source/messages-pt_br.po`` in the reference tree, loaded at
#: ``src/gui/monkey_app.cpp:26-28``)
_VENDORED_PO = Path(__file__).parent / "assets" / "i18n" / "messages-pt_br.po"


def _install_vendored_catalog() -> None:
    """Merge the reference's full pt_BR catalog over the built-in subset.

    The reference's msgids embed ``\\n`` line breaks (``constants.hpp:30-46``)
    while this framework's user-facing strings are single-line, so each
    vendored entry also registers a whitespace-flattened alias.  The vendored
    catalog wins on overlap (it is the reference's shipped data); the built-in
    subset covers strings newer than the catalog (CLI strings, warnings added
    after 0.5).
    """
    if not _VENDORED_PO.exists():
        return
    try:
        vendored = load_po(_VENDORED_PO)
    except Exception:
        return
    merged: Dict[str, str] = dict(_PT_BR)
    for key, val in vendored.items():
        merged[key] = val
        merged.setdefault(" ".join(key.split()), val)
    # ``constants.hpp:38`` ships a typo ("containg"); validate.py uses the
    # corrected spelling — alias the translation to both forms.
    typo = (
        "You must input a keyword containg ONLY characters found in your "
        "defined charset."
    )
    if typo in merged:
        merged.setdefault(typo.replace("containg", "containing"), merged[typo])
    CATALOGS["pt_br"] = merged
    CATALOGS["pt"] = merged


def load_po(path) -> Dict[str, str]:
    """Minimal ``.po`` reader (msgid/msgstr pairs, single- or multi-line)."""
    catalog: Dict[str, str] = {}
    text = Path(path).read_text(encoding="utf-8")
    entries = re.findall(
        r'msgid\s+((?:"(?:[^"\\]|\\.)*"\s*)+)msgstr\s+'
        r'((?:"(?:[^"\\]|\\.)*"\s*)+)',
        text,
    )

    def unquote(chunk: str) -> str:
        parts = re.findall(r'"((?:[^"\\]|\\.)*)"', chunk)
        joined = "".join(parts)
        # resolve \n/\"/\uXXXX escapes without mangling non-ASCII text
        return joined.encode("latin-1", "backslashreplace").decode(
            "unicode_escape"
        )

    for mid, mstr in entries:
        key, val = unquote(mid), unquote(mstr)
        if key and val:
            catalog[key] = val
    return catalog


def set_language(lang: Optional[str]) -> None:
    """Activate a language ('en' / 'pt_br' / registered catalog name)."""
    global _active, _lang
    if not lang or lang.lower().startswith("en"):
        _active, _lang = None, "en"
        return
    key = lang.lower().replace("-", "_")
    for probe in (key, key.split("_")[0], key.split(".")[0]):
        if probe in CATALOGS:
            _active, _lang = CATALOGS[probe], probe
            return
    _active, _lang = None, "en"


def current_language() -> str:
    return _lang


def _(message: str) -> str:
    """Translate *message* via the active catalog (identity for English)."""
    if _active is None:
        return message
    return _active.get(message, message)


# load the vendored reference catalog, then initialize from environment
_install_vendored_catalog()
set_language(
    os.environ.get("MMTPU_LANG")
    or os.environ.get("LC_ALL")
    or os.environ.get("LANG")
)
