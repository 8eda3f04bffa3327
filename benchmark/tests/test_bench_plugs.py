"""The plug points: a configuration names its reference, a mix its request
and its keyword generator, each a module found by name under the cell's
folder.  Without the keys every cell resolves to the harness's own code; a
missing module names its path; and a cell laid out in another folder, whose
three toy modules make a stream of keyword pairs, search each pair as one
batch and check it keyword by keyword, runs end to end, with ``correct``
decided by the reference that the configuration names."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from bench_small import CELLS, overrides
from benchmark import check, harness, reference, spec, traffic


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_without_the_keys_resolves_to_the_harness_code(
        name, monkeypatch):
    cell = spec.cell(name)
    assert cell.folder == spec.HERE
    assert "reference" not in cell.config
    assert not {"request", "generator"} & set(cell.traffic)
    assert spec.generator(cell) is traffic.make
    plug = spec.request(cell)
    assert Path(plug.__file__) == spec.HERE / "requests" / "engine.py"
    assert not hasattr(plug, "as_tuples")  # check.as_tuples compares

    calls = []
    monkeypatch.setattr(reference, "Grids",
                        lambda *a: calls.append(a) or "grids")
    monkeypatch.setattr(reference, "search",
                        lambda *a: calls.append(a) or ["result"])
    sc = cell.config["search_config"]
    image = np.zeros(16, dtype=np.uint8)
    grids = check.reference_grids(image, cell.config, "cpu")
    assert check.reference_results(grids, cell.config, "word") == ["result"]
    assert calls[0][0] is image and calls[0][1:] == (
        sc["element_width"], sc["endianness"] == "big", "cpu")
    assert calls[1] == ("grids", "word", sc.get("custom_char_seq", ""),
                        sc["preferred_search_block_size"],
                        sc["preferred_preview_width"], "signed")


GENERATOR = '''
"""Two keywords a stream entry: the default generator's, paired."""
from benchmark import traffic


def make(config, mix, seed, device="cpu", n_bytes=None):
    work = traffic.make(config, mix, seed, device, n_bytes=n_bytes)
    words = work.keywords
    work.keywords = list(zip(words[0::2], words[1::2]))
    work.warm = work.keywords[0]
    return work
'''

REQUEST = '''
"""A keyword pair as one batch through MultiSearcher."""
from benchmark.harness import search_config


def make(config, path, device, search_config_overrides):
    from monkey_moore_tpu_torch.multi import MultiSearcher

    sc = search_config(config, "", path, search_config_overrides)
    searcher = MultiSearcher(
        path, element_width=sc.element_width, endianness=sc.endianness,
        preferred_search_block_size=sc.preferred_search_block_size,
        device_chunk_bytes=sc.device_chunk_bytes,
        preferred_preview_width=sc.preferred_preview_width,
        semantics=sc.semantics, device=device)

    def request(entry):
        lists = searcher.search(list(entry), generate_previews=True)
        return None, [(kw, r) for kw, rs in zip(entry, lists) for r in rs]

    return request


def as_tuples(results):
    return [(kw, int(r.offset), {int(k): int(v)
                                 for k, v in r.values_map.items()},
             str(r.preview)) for kw, r in results]
'''

REFERENCE = '''
"""The plain reference, once per keyword of a pair."""
from benchmark import reference

DROP = {drop}


def grids(image, config, device):
    sc = config["search_config"]
    return reference.Grids(image, int(sc["element_width"]),
                           sc["endianness"] == "big", device)


def results(grids, config, entry, compare="signed"):
    sc = config["search_config"]
    out = []
    for kw in entry:
        out += [(kw,) + r for r in reference.search(
            grids, kw, sc["custom_char_seq"],
            int(sc["preferred_search_block_size"]),
            int(sc["preferred_preview_width"]), compare)]
    return out[:-1] if DROP else out
'''


def toy_folder(root: Path, reference_name: str) -> Path:
    """A ``BENCHMARK.json`` and a folder laid out like ``benchmark/`` under
    *root*, with one cell, ``toy_batch2``, whose three plug modules are the
    toys above; returns the folder."""
    folder = root / "benchmark"
    shutil.copytree(spec.HERE / "metrics", folder / "metrics")
    repo = spec.load_spec()
    e2e = {m["name"]: m for m in repo["end_to_end"]}
    (root / "BENCHMARK.json").write_text(json.dumps({
        "command": repo["command"], "paths": ["benchmark"], "run_seconds": 10,
        "configs": [{"name": "toy_u8", "source": "a test",
                     "file": "benchmark/configs/toy_u8.json", "reduced": [],
                     "why": "a test"}],
        "workloads": [{"name": "toy_batch2", "config": "toy_u8",
                       "traffic": "toy_pairs", "chips": 1, "why": "a test"}],
        "end_to_end": [dict(e2e["search_ms_p50"], workloads=["toy_batch2"]),
                       e2e["setup_s"]],
        "per_layer": []}))
    config = spec.load_json("configs", "dvd5_u8")
    mix = spec.load_json("traffic", "sparse_words")
    files = {
        "configs/toy_u8.json": json.dumps(
            dict(config, name="toy_u8", reference=reference_name)),
        "traffic/toy_pairs.json": json.dumps(
            dict(mix, request="toy_multi", generator="toy_pairs")),
        "generators/toy_pairs.py": GENERATOR,
        "requests/toy_multi.py": REQUEST,
        "references/toy_pairs.py": REFERENCE.format(drop=False),
        "references/toy_drop_one.py": REFERENCE.format(drop=True),
    }
    for rel, text in files.items():
        (folder / rel).parent.mkdir(parents=True, exist_ok=True)
        (folder / rel).write_text(text)
    return folder


@pytest.fixture
def one_thread():
    """One torch thread, as ``run.py`` gives a run: the batches' plain
    kernels would otherwise take every core from the suite's other
    workers, whose windows have time limits."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("reference_name", ["toy_pairs", "toy_drop_one"])
def test_plug_points_end_to_end_in_another_folder(reference_name, tmp_path,
                                                  one_thread):
    folder = toy_folder(tmp_path, reference_name)
    cell = spec.cell("toy_batch2", folder=folder)
    assert cell.folder == folder and cell.config["reference"] == reference_name
    work = spec.generator(cell)(cell.config, cell.traffic, 7, "cpu",
                                n_bytes=1 << 20)
    assert all(isinstance(e, tuple) and len(e) == 2 for e in work.keywords)
    result = harness.run(cell, 2**31 + 21, 60.0, False, device="cpu",
                         overrides=overrides(cell), max_requests=3)
    checks = result["checks"]["requests_wrong"]
    assert result["attempted"] == 3 and result["failed"] == 0
    assert checks["compared"] == 3
    assert set(result["metrics"]) == {"search_ms_p50", "setup_s"}
    # the reference that the configuration names decides ``correct``
    assert result["correct"] is (reference_name == "toy_pairs"), checks
    assert checks["value"] == (0 if reference_name == "toy_pairs" else 3)


@pytest.mark.parametrize("kind", ["references", "requests", "generators",
                                  "metrics"])
def test_a_missing_module_names_its_path(kind, tmp_path):
    folder = toy_folder(tmp_path, "toy_pairs")
    cell = spec.cell("toy_batch2", folder=folder)
    (folder / kind).rename(folder / f"{kind}.gone")
    where = {"references": "toy_pairs.py", "requests": "toy_multi.py",
             "generators": "toy_pairs.py", "metrics": "search_ms_p50.py"}[kind]
    resolve = {
        "references": lambda: check.reference_grids(
            np.zeros(16, np.uint8), cell.config, "cpu", folder),
        "requests": lambda: spec.request(cell),
        "generators": lambda: spec.generator(cell),
        "metrics": lambda: spec.read_metrics(cell.end_to_end, None, folder),
    }[kind]
    with pytest.raises(FileNotFoundError,
                       match=f"no file benchmark/{kind}/{where}"):
        resolve()


def test_a_missing_configuration_or_mix_names_its_path(tmp_path):
    folder = toy_folder(tmp_path, "toy_pairs")
    (folder / "traffic" / "toy_pairs.json").unlink()
    with pytest.raises(FileNotFoundError,
                       match="no file benchmark/traffic/toy_pairs.json"):
        spec.cell("toy_batch2", folder=folder)
