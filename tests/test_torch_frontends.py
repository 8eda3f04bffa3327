"""The PyTorch port's copies of the frontends' host modules against their
originals: ``validate``, ``tables``, ``sequences``, ``i18n`` (with its own
copy of the pt_BR catalog) and ``prefs``.

The port imports nothing of the JAX package, so its CLI, REPL and TUI run
on copies of these modules; what the user sees stays the same only while
each copy gives its original's answers, tables, files and translations.
Each is held against its original on the same inputs.

Tolerance: exact equality throughout — every value is an integer, a
string, an enum member or the bytes of a file.
"""

import importlib.util
import os

import pytest

import monkey_moore_tpu.config as jconfig
import monkey_moore_tpu.i18n as ji18n
import monkey_moore_tpu.prefs as jprefs
import monkey_moore_tpu.sequences as jsequences
import monkey_moore_tpu.tables as jtables
import monkey_moore_tpu.validate as jvalidate
from monkey_moore_tpu_torch import config as tconfig
from monkey_moore_tpu_torch import i18n as ti18n
from monkey_moore_tpu_torch import prefs as tprefs
from monkey_moore_tpu_torch import sequences as tsequences
from monkey_moore_tpu_torch import tables as ttables
from monkey_moore_tpu_torch import validate as tvalidate
from common import HIRAGANA_SEQ
from test_torch_copies import KEYWORDS, KEYWORD_IDS

HIRA = jsequences.DEFAULT_HIRAGANA


def same_warning(got, want):
    if want is None:
        assert got is None
    else:
        assert type(got).__name__ == "Warning_"
        assert (got.name, got.value) == (want.name, want.value)


# ---- validate ---------------------------------------------------------------

#: the cases of ``tests/test_ux.py``'s TestValidation: (keyword, wildcard,
#: char_seq)
UX_KEYWORDS = [
    ("ab", "*", ()), ("catch", "*", ()), ("AbCd", "*", ()),
    ("ABCd", "*", ()), ("ab**", "*", ()), ("ab1de", "*", ()),
    ("ab*de", "*", ()), ("あ**", "*", HIRA), ("あいう*", "あ", HIRA),
    ("abc", "*", "aab c"), ("あいx", "*", HIRA), ("あいう", "*", HIRA),
    ("ab*de", None, ()), ("ab*de", "", ()), ("わたし", 0, HIRAGANA_SEQ),
]


@pytest.mark.parametrize("args,kwargs", KEYWORDS, ids=KEYWORD_IDS)
def test_check_keyword_on_the_pattern_keywords(args, kwargs):
    if not args:  # a value scan: its values through the parser
        text = " ".join(map(str, kwargs["reference_values"]))
        assert (tvalidate.parse_value_scan(text)
                == jvalidate.parse_value_scan(text))
        return
    call = (args[0], kwargs.get("wildcard", "*"), kwargs.get("char_seq", ()))
    same_warning(tvalidate.check_keyword(*call),
                 jvalidate.check_keyword(*call))


@pytest.mark.parametrize("call", UX_KEYWORDS,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(UX_KEYWORDS)])
def test_check_keyword_on_the_ux_cases(call):
    same_warning(tvalidate.check_keyword(*call),
                 jvalidate.check_keyword(*call))


@pytest.mark.parametrize("text", [
    "60 61, 62", "60 -1", "abc", "", "  ,  ", "1,2,3", "007 8", "60\t61",
    "٣ 4"])
def test_parse_value_scan(text):
    try:
        want = jvalidate.parse_value_scan(text)
    except jvalidate.ValidationError as exc:
        with pytest.raises(tvalidate.ValidationError) as got:
            tvalidate.parse_value_scan(text)
        assert str(got.value) == str(exc)
        same_warning(got.value.warning, exc.warning)
        return
    assert tvalidate.parse_value_scan(text) == want


@pytest.mark.parametrize("use,field", [
    (True, ""), (True, "**"), (True, "*"), (False, ""), (False, "ab")])
def test_check_wildcard_field(use, field):
    same_warning(tvalidate.check_wildcard_field(use, field),
                 jvalidate.check_wildcard_field(use, field))


def test_warning_texts():
    assert ([(w.name, w.value) for w in tvalidate.Warning_]
            == [(w.name, w.value) for w in jvalidate.Warning_])


# ---- tables -----------------------------------------------------------------

TABLE_CASES = [
    ({ord("a"): 0x41}, 1),
    ({ord("A"): 250, ord("a"): 3}, 1),  # wraparound at the type's maximum
    ({ord("a"): 0x1234, ord("!"): 0x20}, 2),
    ({ord("A"): 65530}, 2),
    ({ord("あ"): 5, ord("い"): 6}, 1),  # not ANSI
    ({ord("é"): 0xE9, ord("x"): 7}, 1),
]


@pytest.mark.parametrize("values_map,width", TABLE_CASES)
@pytest.mark.parametrize("endian", ["LITTLE", "BIG"])
def test_table_data_and_text(values_map, width, endian):
    want = jtables.build_table_data(values_map, width,
                                    jconfig.Endianness[endian])
    got = ttables.build_table_data(values_map, width,
                                   tconfig.Endianness[endian])
    assert list(got.items()) == list(want.items())
    assert ttables.format_tbl(got) == jtables.format_tbl(want)


@pytest.mark.parametrize("values_map,width", TABLE_CASES)
@pytest.mark.parametrize("encoding", ["ansi", "utf-8", "utf-16", "UTF-8",
                                      "latin-2"])
def test_save_tbl_bytes(tmp_path, values_map, width, encoding):
    table = jtables.build_table_data(values_map, width)
    want_path, got_path = tmp_path / "want.tbl", tmp_path / "got.tbl"
    try:
        jtables.save_tbl(want_path, table, encoding)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            ttables.save_tbl(got_path, table, encoding)
        assert str(got.value) == str(exc)
        assert not got_path.exists()
        return
    ttables.save_tbl(got_path, table, encoding)
    assert got_path.read_bytes() == want_path.read_bytes()


# ---- sequences --------------------------------------------------------------


def _edit(store, ops):
    for op, *args in ops:
        getattr(store, op)(*args)
    return store


SEQ_EDITS = [
    [],
    [("add", "Mine", "abc")],
    [("add", "Default Hiragana sequence", "xyz"), ("add", "b", "漢字")],
    [("remove", "Default Katakana sequence"), ("add", "k", "<&>\"'")],
    [("remove", "nothing"), ("reset_defaults",)],
]


@pytest.mark.parametrize("ops", SEQ_EDITS, ids=range(len(SEQ_EDITS)))
def test_sequence_store(tmp_path, ops):
    want = _edit(jsequences.SequenceStore(), ops)
    got = _edit(tsequences.SequenceStore(), ops)
    assert got.names() == want.names() and got.items() == want.items()
    for name in want.names():
        assert got.get(name) == want.get(name)
    with pytest.raises(KeyError):
        got.get("no such sequence")
    want.save(tmp_path / "want.xml")
    got.save(tmp_path / "got.xml")
    assert ((tmp_path / "got.xml").read_bytes()
            == (tmp_path / "want.xml").read_bytes())
    back = tsequences.SequenceStore()
    back.load(tmp_path / "want.xml")
    assert back.items() == want.items()


@pytest.mark.parametrize("text", [
    "not xml", "<other/>", "<monkey-moore-sequences/>",
    "<monkey-moore-sequences><sequence>x</sequence>"
    "<sequence name='n'/></monkey-moore-sequences>"])
def test_sequence_store_load_odd_files(tmp_path, text):
    path = tmp_path / "s.xml"
    path.write_text(text, encoding="utf-8")
    want, got = jsequences.SequenceStore(), tsequences.SequenceStore()
    want.load(path)
    got.load(path)
    assert got.items() == want.items()
    assert (tsequences.DEFAULT_HIRAGANA, tsequences.DEFAULT_KATAKANA) == (
        jsequences.DEFAULT_HIRAGANA, jsequences.DEFAULT_KATAKANA)


# ---- prefs ------------------------------------------------------------------

PREF_WRITES = [
    [],
    [("settings/display-preview-width", 5)],
    [("settings/display-preview-width", 500),
     ("settings/perf-memory-pool", 1)],
    [("settings/perf-search-threads", 99), ("ui-state/dedup", True)],
    [("settings/perf-search-threads", "x"), ("directories/open-file", "/a")],
    [("settings/perf-memory-pool", 1 << 30), ("new/key", False)],
]


def _prefs(module, writes):
    p = module.Prefs()
    for key, value in writes:
        p.set(key, value)
    return p


@pytest.mark.parametrize("writes", PREF_WRITES, ids=range(len(PREF_WRITES)))
def test_prefs_defaults_bounds_and_xml(tmp_path, writes):
    want, got = _prefs(jprefs, writes), _prefs(tprefs, writes)
    assert got.values == want.values
    for key in list(want.values) + ["missing/key"]:
        assert got.get_int(key, 3) == want.get_int(key, 3)
        assert got.get_bool(key, True) == want.get_bool(key, True)
    want.save(tmp_path / "want.xml")
    got.save(tmp_path / "got.xml")
    assert ((tmp_path / "got.xml").read_bytes()
            == (tmp_path / "want.xml").read_bytes())
    back = tprefs.Prefs()
    back.load(tmp_path / "want.xml")
    assert back.values == want.values
    assert back.loaded_keys == set(want.values)


def test_prefs_constants_and_clamp():
    assert tprefs.PREFS_VERSION == jprefs.PREFS_VERSION
    assert tprefs.SETTINGS_BOUNDS == jprefs.SETTINGS_BOUNDS
    for key in list(jprefs.SETTINGS_BOUNDS) + ["other"]:
        for value in (-1, 0, 1, 20, 51, 1 << 20, 1 << 30):
            assert (tprefs.clamp_setting(key, value)
                    == jprefs.clamp_setting(key, value))


@pytest.mark.parametrize("text", [
    None, "garbage", "<other/>", "<monkey-moore-config version='0.9'/>",
    "<monkey-moore-config version='1.1.0'><settings>"
    "<display-preview-width value='7'/></settings></monkey-moore-config>"])
def test_load_user_prefs(tmp_path, text):
    path = tmp_path / "c.xml"
    if text is not None:
        path.write_text(text)
    want, want_warning = jprefs.load_user_prefs(path)
    got, got_warning = tprefs.load_user_prefs(path)
    assert got_warning == want_warning
    assert got.values == want.values and got.loaded_keys == want.loaded_keys


def test_default_prefs_path(monkeypatch, tmp_path):
    monkeypatch.delenv("MMTPU_PREFS", raising=False)
    monkeypatch.delenv("XDG_CONFIG_HOME", raising=False)
    assert tprefs.default_prefs_path() == jprefs.default_prefs_path()
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    assert tprefs.default_prefs_path() == jprefs.default_prefs_path()
    monkeypatch.setenv("MMTPU_PREFS", str(tmp_path / "mine.xml"))
    assert tprefs.default_prefs_path() == tmp_path / "mine.xml"
    assert jprefs.default_prefs_path() == tmp_path / "mine.xml"


def test_search_config_from_prefs():
    writes = [("settings/perf-memory-pool", 1 << 21),
              ("settings/display-preview-width", 33),
              ("settings/perf-device-chunk", 1 << 22)]
    want = jprefs.search_config_from_prefs(_prefs(jprefs, writes),
                                           keyword="abc")
    got = tprefs.search_config_from_prefs(_prefs(tprefs, writes),
                                          keyword="abc")
    assert isinstance(got, tconfig.SearchConfig)
    for name in ("preferred_search_block_size", "preferred_num_threads",
                 "preferred_preview_width", "device_chunk_bytes", "keyword"):
        assert getattr(got, name) == getattr(want, name), name


# ---- i18n -------------------------------------------------------------------


@pytest.fixture
def english():
    yield
    ji18n.set_language("en")
    ti18n.set_language("en")


def _msgids():
    catalog = ji18n.load_po(ji18n._VENDORED_PO)
    return sorted(set(catalog) | set(ji18n._PT_BR)
                  | {w.value for w in jvalidate.Warning_})


def test_the_port_reads_its_own_catalog():
    assert ti18n._VENDORED_PO.parent.parent.parent.name == (
        "monkey_moore_tpu_torch")
    assert ti18n._VENDORED_PO.read_bytes() == ji18n._VENDORED_PO.read_bytes()
    assert (ti18n.load_po(ti18n._VENDORED_PO)
            == ji18n.load_po(ji18n._VENDORED_PO))
    assert ti18n.CATALOGS == ji18n.CATALOGS


@pytest.mark.parametrize("lang", [None, "en", "pt_BR", "pt_BR.UTF-8", "pt",
                                  "de_DE"])
def test_translations_of_every_msgid(english, lang):
    ji18n.set_language(lang)
    ti18n.set_language(lang)
    assert ti18n.current_language() == ji18n.current_language()
    ids = _msgids()
    assert len(ids) > 100
    assert [ti18n._(m) for m in ids] == [ji18n._(m) for m in ids]


def _fresh(module, name):
    spec = importlib.util.spec_from_file_location(name, module.__file__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    return fresh


@pytest.mark.parametrize("env", [
    {}, {"MMTPU_LANG": "pt_BR"}, {"LC_ALL": "pt_BR.UTF-8"},
    {"LANG": "pt_BR"}, {"LANG": "en_US.UTF-8"},
    {"MMTPU_LANG": "en", "LANG": "pt_BR"}])
def test_language_from_the_environment(monkeypatch, env):
    for key in ("MMTPU_LANG", "LC_ALL", "LANG"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    want = _fresh(ji18n, "_j_i18n_fresh")
    got = _fresh(ti18n, "_t_i18n_fresh")
    assert got.current_language() == want.current_language()
    msg = "File not found"
    assert got._(msg) == want._(msg)
    assert os.path.samefile(got._VENDORED_PO, ti18n._VENDORED_PO)
