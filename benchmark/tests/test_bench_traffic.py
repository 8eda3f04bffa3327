"""The traffic generator and the files that ``BENCHMARK.json`` names:
the same seed gives the same image and stream, plants sit where the
generator says, and every workload resolves by name to its files."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from bench_small import CELLS, IMAGE, mix
from benchmark import spec, traffic

ROOT = Path(spec.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def build(name, seed, n_bytes=IMAGE):
    cell = spec.cell(name)
    return cell, traffic.make(cell.config, mix(cell), seed, "cpu",
                              n_bytes=n_bytes)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_image_and_stream(name):
    _, a = build(name, 2**31 + 9)
    _, b = build(name, 2**31 + 9)
    _, c = build(name, 2**31 + 10)
    assert np.array_equal(a.image, b.image)
    assert not np.array_equal(a.image, c.image)
    assert a.keywords == b.keywords and a.warm == b.warm
    assert [(p.keyword, p.offset, p.decoy) for p in a.plants] == [
        (p.keyword, p.offset, p.decoy) for p in b.plants]
    sa, sb = a.stream(), b.stream()
    assert [next(sa) for _ in range(300)] == [next(sb) for _ in range(300)]


@pytest.mark.parametrize("name", CELLS)
def test_plants_hold_their_keyword_where_the_generator_says(name):
    cell, work = build(name, 5)
    sc = cell.config["search_config"]
    width, big = sc["element_width"], sc["endianness"] == "big"
    seq = sc.get("custom_char_seq", "")
    top = 1 << (8 * width)
    spans = []
    for p in work.plants:
        values = traffic.keyword_values(work.keywords[p.keyword], seq)
        raw = work.image[p.offset : p.offset + len(values) * width]
        if width == 2:
            pairs = raw.astype(np.int64).reshape(-1, 2)
            got = pairs[:, 0] * 256 + pairs[:, 1] if big else (
                pairs[:, 1] * 256 + pairs[:, 0])
        else:
            got = raw.astype(np.int64)
        shift = got[0] - values[0]
        assert np.array_equal(got % top, (values + shift) % top)
        # a decoy's values wrap past the top: no one signed shift fits
        assert np.array_equal(got, values + shift) != p.decoy
        spans.append((p.offset, p.offset + len(raw)))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    if work.script is not None:
        lo, n = work.script
        assert all(e <= lo or s >= lo + n for s, e in spans)
    assert any(p.decoy for p in work.plants)
    counts = np.bincount([p.keyword for p in work.plants])
    lo_n, hi_n = cell.traffic["plants"]["min"], cell.traffic["plants"]["max"]
    assert counts.min() >= lo_n and counts.max() <= hi_n


def test_script_is_the_word_list_under_one_shift():
    cell, work = build("u8_dense", 8)
    lo, n = work.script
    region = work.image[lo : lo + n].astype(np.int64)
    words = set(traffic.word_list(cell.traffic["keywords"]))
    for shift in range(-97, 134):
        text = bytes(((region - shift) % 256).tolist())
        tokens = text.split(b" ")
        if len(tokens) > 1000 and all(
                t.decode("latin-1") in words for t in tokens[1:-1]):
            break
    else:
        pytest.fail("the script decodes under no shift")


def test_script_stream_asks_for_words_by_their_count():
    _, work = build("u8_dense", 8)
    stream = work.stream()
    picks = [next(stream) for _ in range(32 * 40)]
    assert all(work.weights[k] > 0 for k in picks)
    top = int(np.argmax(work.weights))
    share = work.weights[top] / work.weights.sum()
    blocks = np.array(picks).reshape(40, 32)
    per_block = (blocks == top).sum(axis=1)
    assert abs(per_block.mean() - 32 * share) < 0.5
    assert per_block.max() - per_block.min() <= 1  # stratified


def test_uniform_stream_visits_every_keyword_once_a_cycle():
    _, work = build("u8_sparse", 3)
    stream = work.stream()
    n = len(work.keywords)
    assert sorted(next(stream) for _ in range(n)) == list(range(n))


def test_kana_keywords_are_sequence_strings_of_the_given_lengths():
    cell, work = build("u16be_kana", 4)
    seq = cell.config["search_config"]["custom_char_seq"]
    kw = cell.traffic["keywords"]
    assert all(set(k) <= set(seq) for k in work.keywords)
    assert {len(k) for k in work.keywords} == set(
        range(kw["min_len"], kw["max_len"] + 1))


def test_word_list_is_plain_and_distinct():
    words = traffic.word_list({"file": "data/english_words.txt"})
    assert len(words) == len(set(words)) == 1000
    assert all(re.fullmatch(r"[a-z]+", w) for w in words)


# ---------------------------------------------------------------------------
# BENCHMARK.json and the files it names

SPEC = spec.load_spec()


def test_every_workload_resolves_by_name_to_its_files():
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names))
    for name in names:
        cell = spec.cell(name)
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m.name for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m.name))
        reported = {m.name for m in cell.end_to_end}
        assert all(m.moves in reported for m in cell.per_layer)


def test_configs_are_used_and_their_files_lie_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.is_file()
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert json.loads(path.read_text())["name"] == c["name"]
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_names_units_and_keys_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for path in (ROOT / "benchmark").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= SPEC["run_seconds"] <= 51 and total <= 43200
