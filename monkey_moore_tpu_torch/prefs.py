"""Preference store.

The PyTorch port's copy of the JAX package's ``prefs.py``
(``tests/test_torch_frontends.py`` holds it equal to the original).

Mirror of ``MonkeyPrefs`` (``src/gui/monkey_prefs.cpp``): a flat
``"category/name" → string`` map with typed accessors, versioned XML
persistence (``<monkey-moore-config version=...>`` with one element per
category and ``value`` attributes per property, ``monkey_prefs.cpp:46-94``),
and factory defaults (``monkey_prefs.cpp:20-44``) including the performance
knobs that feed :class:`~monkey_moore_tpu_torch.config.SearchConfig`
(``perf-memory-pool`` = 8 MiB block size, ``perf-search-threads`` = 4).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, Union

__all__ = [
    "PrefsError",
    "Prefs",
    "PREFS_VERSION",
    "SETTINGS_BOUNDS",
    "clamp_setting",
    "default_prefs_path",
    "load_user_prefs",
    "search_config_from_prefs",
]

PREFS_VERSION = "1.1.0"  # MM_VERSION (``constants.hpp:8``)
_ROOT_TAG = "monkey-moore-config"

#: UI-enforced bounds for the performance/display knobs, mirroring the
#: settings dialog's spin-control ranges: preview width 20-50 characters,
#: memory pool 1-64 MB (stored in bytes), search threads 1-16
#: (``src/gui/dialogs/settings.cpp:50,64,74``).
SETTINGS_BOUNDS = {
    "settings/display-preview-width": (20, 50),
    "settings/perf-memory-pool": (1 * 1024 * 1024, 64 * 1024 * 1024),
    "settings/perf-search-threads": (1, 16),
}


def clamp_setting(key: str, value: int) -> int:
    """Clamp *value* into the UI bounds for *key* (identity for unbounded
    keys) — the behavior of the reference's ``wxSpinCtrl::SetRange``."""
    bounds = SETTINGS_BOUNDS.get(key)
    if bounds is None:
        return value
    lo, hi = bounds
    return min(hi, max(lo, value))


class PrefsError(Exception):
    """Parse failure / version mismatch (mirrors ``monkeymoore_error`` with
    MMError_ConfigParseFailed / MMError_ConfigVersionMismatch)."""


class Prefs:
    def __init__(self):
        self.values: Dict[str, str] = {}
        #: keys that came from an XML file (vs factory defaults) — lets
        #: callers apply only explicitly-persisted knobs
        self.loaded_keys: set = set()
        self.set_default_values()

    def set_default_values(self) -> None:
        """Factory defaults (``monkey_prefs.cpp:20-44``), minus the
        window-geometry entries that only make sense for the wx GUI."""
        self.values = {
            "settings/ui-center-window": "true",
            "settings/ui-remember-size": "true",
            "settings/ui-remember-position": "false",
            "settings/ui-remember-state": "true",
            "settings/display-preview-width": "50",
            "settings/display-offset-mode": "hex",
            "settings/perf-memory-pool": "8388608",
            "settings/perf-search-threads": "4",
            # TPU-native additions
            "settings/perf-device-chunk": str(512 * 1024 * 1024),
            "settings/perf-match-semantics": "greedy",
            "ui-state/search-type": "rs",
            "ui-state/search-mode": "8-bit",
            "ui-state/wildcard": "*",
            "ui-state/advanced-shown": "true",
            "ui-state/endianness-little": "true",
            "ui-state/show-all-results": "true",
            "directories/open-file": "",
            "directories/save-table": "",
        }

    # ------------------------------------------------------------------
    def get(self, key: str, default: str = "") -> str:
        return self.values.get(key, default)

    def set(self, key: str, value) -> None:
        if isinstance(value, bool):
            value = "true" if value else "false"
        if key in SETTINGS_BOUNDS:
            # mirror the settings dialog's spin-control clamping
            # (``settings.cpp:50,64,74``): out-of-range writes snap to the
            # nearest bound rather than persisting
            try:
                value = clamp_setting(key, int(value))
            except (TypeError, ValueError):
                pass
        self.values[key] = str(value)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.values.get(key)
        if v is None:
            return default
        return v.lower() == "true"

    def get_int(self, key: str, default: int = 0) -> int:
        """Typed accessor; UI-bounded keys (``SETTINGS_BOUNDS``) are clamped
        on read so a hand-edited XML cannot smuggle an out-of-range knob past
        the settings dialog's ranges (``settings.cpp:50,64,74``)."""
        try:
            value = int(self.values.get(key, default))
        except (TypeError, ValueError):
            return default
        return clamp_setting(key, value)

    # ------------------------------------------------------------------
    def save(self, path: Union[str, Path]) -> None:
        root = ET.Element(_ROOT_TAG, {"version": PREFS_VERSION})
        categories: Dict[str, ET.Element] = {}
        for key, value in self.values.items():
            cat, _, name = key.partition("/")
            if cat not in categories:
                categories[cat] = ET.SubElement(root, cat)
            ET.SubElement(categories[cat], name, {"value": value})
        tree = ET.ElementTree(root)
        ET.indent(tree)
        tree.write(path, encoding="utf-8", xml_declaration=True)

    def load(self, path: Union[str, Path]) -> None:
        """Load, raising :class:`PrefsError` on parse failure, missing root
        or version mismatch (``monkey_prefs.cpp:46-94``) so callers can offer
        the reference's restore-defaults-or-quit recovery
        (``src/gui/monkey_app.cpp:87-113``)."""
        try:
            root = ET.parse(path).getroot()
        except (ET.ParseError, OSError) as e:
            raise PrefsError(
                f"An error prevented user preferences from being loaded. "
                f"File: {path}"
            ) from e
        if root.tag != _ROOT_TAG:
            raise PrefsError("Invalid configuration file: missing root node.")
        if root.get("version") != PREFS_VERSION:
            raise PrefsError(
                "Version is different from the version used in the user "
                "preferences file."
            )
        for category in root:
            for prop in category:
                value = prop.get("value")
                if value is not None:
                    key = f"{category.tag}/{prop.tag}"
                    self.values[key] = value
                    self.loaded_keys.add(key)


def default_prefs_path() -> Path:
    """User config file location — the headless analog of the reference's
    ``wxStandardPaths`` user data dir (``monkey_app.cpp:31-35``).
    Overridable via ``MMTPU_PREFS``."""
    import os

    env = os.environ.get("MMTPU_PREFS")
    if env:
        return Path(env)
    base = os.environ.get("XDG_CONFIG_HOME") or str(Path.home() / ".config")
    return Path(base) / "monkey-moore-tpu" / "config.xml"


def load_user_prefs(path=None):
    """Load the user prefs with the reference's recovery behavior
    (``monkey_app.cpp:79-113``): a missing file yields factory defaults
    silently; a corrupt/mismatched file yields factory defaults plus the
    error text for the caller to surface (the headless stand-in for the
    restore-defaults-or-quit dialog).

    Returns ``(Prefs, warning_or_None)``.
    """
    p = Path(path) if path else default_prefs_path()
    prefs = Prefs()
    if not p.exists():
        return prefs, None
    try:
        prefs.load(p)
        return prefs, None
    except PrefsError as e:
        return Prefs(), str(e)


def search_config_from_prefs(prefs: Prefs, **overrides):
    """Build a :class:`~monkey_moore_tpu_torch.config.SearchConfig` the way the
    reference GUI does (``monkey_frame.cpp:555-565``): the performance and
    display knobs come from the preference store, and the result passes
    through the settings-dialog bounds (``SearchConfig.clamp_ui_bounds``,
    matching ``settings.cpp:50,64,74``).  ``overrides`` set the
    search-specific fields (file, keyword, width, ...)."""
    from .config import SearchConfig

    cfg = SearchConfig(
        preferred_search_block_size=prefs.get_int(
            "settings/perf-memory-pool", 8 * 1024 * 1024
        ),
        preferred_num_threads=prefs.get_int(
            "settings/perf-search-threads", 4
        ),
        preferred_preview_width=prefs.get_int(
            "settings/display-preview-width", 50
        ),
        device_chunk_bytes=prefs.get_int(
            "settings/perf-device-chunk", 512 * 1024 * 1024
        ),
    ).clamp_ui_bounds()
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg
