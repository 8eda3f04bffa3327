"""The wildcard deployment (configuration ``dvd5_u8_wild``, mix
``wild_words``, cell ``u8_wild``): its reference on hand-made images, its
generator, the port held to the reference through the harness, the
control found out, and the reader of ``step.prefilter_excess_share``."""

from types import SimpleNamespace

import numpy as np
import pytest

from bench_small import IMAGE, PORT, overrides
from benchmark import check, control, harness, spec
from benchmark.harness import ImageFile, search_config

#: the cells of this deployment (``bench_small.CELLS`` holds the others)
CELLS = ["u8_wild"]
CONFIG = spec.load_json("configs", "dvd5_u8_wild")
wildcard = spec.module("references", "wildcard")
wild_words = spec.module("generators", "wild_words")


def noise(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def results(data, keyword, compare="signed", config=CONFIG):
    grids = check.reference_grids(data, config, "cpu")
    return check.reference_results(grids, config, keyword, compare=compare)


def port(data, keyword, config=CONFIG):
    from monkey_moore_tpu_torch.engine import SearchEngine

    image = ImageFile(data)
    try:
        engine = SearchEngine(search_config(config, keyword, image.path,
                                            PORT), device="cpu")
        return check.as_tuples(engine.run(generate_previews=True))
    finally:
        image.close()


def plant(data, offset, keyword, lower, upper, raise_by=0):
    """One copy of *keyword*: each case under its own base, modulo 256, and
    every literal past the wildcard raised by *raise_by*; the wildcard's
    byte is left as it was."""
    star = keyword.find("*")
    for i, c in enumerate(keyword):
        if c != "*":
            base = upper - ord("A") if c.isupper() else lower - ord("a")
            data[offset + i] = (base + ord(c) + (
                raise_by if 0 <= star < i else 0)) % 256


def test_a_bridge_decoy_is_no_match_but_the_control_reports_it():
    data = noise(1 << 20)
    plant(data, 1000, "pr*ncess", 40, 0)
    plant(data, 5000, "pr*ncess", 40, 0, raise_by=9)
    found = [r[0] for r in results(data, "pr*ncess")]
    assert 1000 in found and 5000 not in found
    assert 5000 in [r[0] for r in results(data, "pr*ncess", "wrap")]
    assert [r[0] for r in port(data, "pr*ncess")] == found


def test_a_copy_that_wraps_past_255_is_a_match():
    data = noise(1 << 20, seed=4)
    plant(data, 777, "sc*ool", 250, 0)  # 's' = 250 + 18 wraps to 12
    got = results(data, "sc*ool")
    hit = {r[0]: r[1] for r in got}
    assert hit[777] == {65: (250 - 32) % 256, 97: 250}
    assert got == port(data, "sc*ool")


def test_a_leading_wildcard_shortens_the_greedy_advance():
    # in a run of equal bytes every window of "A*aaaa" and "a*aaaa"
    # matches; "A*aaaa" folds to "**aaaa", whose advance is 6 - 1 - 2 = 3,
    # where "a*aaaa" keeps L - 1 = 5
    data = noise(1 << 20, seed=5)
    data[2000:2040] = 7
    for keyword, advance in (("A*aaaa", 3), ("a*aaaa", 5)):
        assert wildcard.Pattern(keyword).advance == advance
        got = results(data, keyword)
        found = [r[0] for r in got if 1990 <= r[0] < 2040]
        assert len(found) > 5
        assert set(np.diff(found).tolist()) == {advance}, keyword
        assert got == port(data, keyword)


def test_a_capitalised_plant_gives_both_bases():
    data = noise(1 << 20, seed=6)
    plant(data, 4321, "Princess", 12, 200)
    got = results(data, "Princess")
    hit = {r[0]: r for r in got}
    assert hit[4321][1] == {65: 200, 97: 12}
    # the preview decodes the capital through its own base
    assert "Princess" in hit[4321][2]
    control_map = {r[0]: r[1] for r in results(data, "Princess", "wrap")}
    assert control_map[4321] == {65: (12 - 32) % 256, 97: 12}
    assert got == port(data, "Princess")


@pytest.mark.parametrize("keyword", ["PRINcess", "PrInCeSs"])
def test_a_tie_keyword_follows_the_tie_rule(keyword):
    # four of each case: the uppercase letters become wildcards, and the
    # case that takes its own shift is lowercase, from its first position
    # (a literal): both shifts come from one element
    data = noise(1 << 20, seed=7)
    pat = wildcard.Pattern(keyword)
    assert pat.mixed and not pat.mostly_lower
    assert [keyword[i] for i in pat.literals] == [
        c for c in keyword if c.islower()]
    plant(data, 9000, keyword, 60, 170)
    hit = {r[0]: r[1] for r in results(data, keyword)}
    assert hit[9000] == {65: (60 - 32) % 256, 97: 60}
    assert results(data, keyword) == port(data, keyword)


def test_a_simple_keyword_is_the_simple_reference():
    from benchmark import reference

    data = noise(1 << 20, seed=8)
    data[500:506] = [ord(c) + 3 for c in "castle"]
    grids = check.reference_grids(data, CONFIG, "cpu")
    assert results(data, "castle") == reference.search(
        grids, "castle", "", 1 << 19, 50)
    assert 500 in [r[0] for r in results(data, "castle")]


def build(seed, n_bytes=IMAGE):
    cell = spec.cell("u8_wild")
    return cell, spec.generator(cell)(cell.config, cell.traffic, seed, "cpu",
                                      n_bytes=n_bytes)


def test_generator_forms_plants_and_seeds():
    cell, a = build(2**31 + 9)
    _, b = build(2**31 + 9)
    _, c = build(2**31 + 10)
    assert np.array_equal(a.image, b.image)
    assert not np.array_equal(a.image, c.image)
    assert a.keywords == b.keywords and a.warm == b.warm
    assert a.keywords != c.keywords
    assert len(a.keywords) == 289
    forms = [(kw[0].isupper(), "*" in kw) for kw in a.keywords]
    assert {f: forms.count(f) for f in set(forms)} == {
        (True, False): 97, (False, True): 96, (True, True): 96}
    for kw in a.keywords:
        assert 6 <= len(kw) <= 10 and kw.count("*") <= 1
        assert kw.find("*") not in (0, len(kw) - 1)
    counts = np.bincount([p.keyword for p in a.plants])
    assert counts.min() == 1 and counts.max() == 8
    spans = sorted((p.offset, p.offset + len(a.keywords[p.keyword]))
                   for p in a.plants)
    assert all(x[1] <= y[0] for x, y in zip(spans, spans[1:]))
    decoys = [p for p in a.plants if p.decoy]
    assert decoys and all(wild_words.bridged(a.keywords[p.keyword], "*")
                          for p in decoys)
    # every plant is where the generator says: a match unless a decoy
    grids = check.reference_grids(a.image, cell.config, "cpu")
    for p in a.plants[:120]:
        kw = a.keywords[p.keyword]
        found = {r[0] for r in check.reference_results(
            grids, cell.config, kw, folder=cell.folder)}
        assert (p.offset in found) is not p.decoy, (kw, p)


def test_reference_equals_port_on_the_mix():
    cell, work = build(2**31 + 77)
    stream = work.stream()
    keywords = {work.keywords[next(stream)] for _ in range(6)}
    keywords.add(work.warm)
    keywords.add(work.keywords[next(p.keyword for p in work.plants
                                    if p.decoy)])
    total = 0
    for kw in sorted(keywords):
        want = results(work.image, kw, config=cell.config)
        assert port(work.image, kw, cell.config) == want, kw
        total += len(want)
    assert total >= len(keywords)


@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_is_correct(name):
    cell = spec.cell(name)
    result = harness.run(cell, 2**31 + 5, 60.0, False, device="cpu",
                         overrides=overrides(cell), max_requests=3)
    assert result["attempted"] == 3 and result["failed"] == 0
    assert result["correct"] is True, result["checks"]
    assert {"search_ms_p50", "search_ms_p95", "scan_GBps",
            "setup_s"} == set(result["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name):
    cell = spec.cell(name)
    result = control.run(cell, 2**31 + 3, 60.0, "cpu",
                         overrides=overrides(cell), max_requests=40)
    checks = result["checks"]["requests_wrong"]
    assert result["attempted"] == 40 and checks["compared"] in (24, 25)
    assert checks["value"] >= 1 and result["correct"] is False


def run_of(counters):
    stats = [SimpleNamespace(record=SimpleNamespace(
        spans=["span"] if c is not None else [], counters=c or {}))
        for c in counters]
    return SimpleNamespace(done=[SimpleNamespace(stats=s) for s in stats])


def test_prefilter_excess_share_reader():
    read = spec.reader("step.prefilter_excess_share")
    run = run_of([{"step.prefilter_windows": 30, "step.exact_windows": 10},
                  {"step.prefilter_windows": 10, "step.exact_windows": 10},
                  None])
    assert read(run) == pytest.approx(50.0)
    assert read(run_of([None, None])) is None
    assert read(run_of([{"step.prefilter_windows": 0}])) is None
    assert read(run_of([{"corpus.read_bytes": 5}])) is None


def test_the_new_entries_of_the_benchmark():
    entries = {m["name"]: m for m in spec.load_spec()["per_layer"]}
    m = entries["step.prefilter_excess_share"]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "program_counter", "fused step", "search_ms_p95",
        ["u8_wild", "u8_sparse"])
    for cell in ("u8_wild", "u8_sparse"):
        assert m["name"] in {x.name for x in spec.cell(cell).per_layer}
    wild = spec.cell("u8_wild")
    sparse = spec.cell("u8_sparse")
    assert [x.name for x in wild.end_to_end] == [
        x.name for x in sparse.end_to_end]
    assert [x.name for x in wild.per_layer] == [
        x.name for x in sparse.per_layer]
    for key in ("image_bytes",):
        assert wild.config[key] == sparse.config[key]
    assert wild.config["search_config"] == dict(
        sparse.config["search_config"], wildcard="*")
    assert wild.config["reduced"] == []
