"""The plain reference equals the port's engine (its kernels' plain
versions on the CPU) on small seeded images of every mix, and on images
built to reach GREEDY suppression, the 16-bit block-fit filter, both byte
orders and wrapped decoys."""

import numpy as np
import pytest

from bench_small import CELLS, IMAGE, PORT, mix
from benchmark import check, spec, traffic
from benchmark.harness import ImageFile, search_config
from monkey_moore_tpu_torch.engine import SearchEngine


def port(config, keyword, image):
    engine = SearchEngine(search_config(config, keyword, image.path, PORT),
                          device="cpu")
    return check.as_tuples(engine.run(generate_previews=True))


def agree(config, data, keywords):
    """Both sides' results of each keyword (asserted equal)."""
    image = ImageFile(data)
    grids = check.reference_grids(data, config, "cpu")
    out = {}
    try:
        for kw in keywords:
            got = port(config, kw, image)
            want = check.reference_results(grids, config, kw)
            assert got == want, (kw, check.first_difference(got, want))
            out[kw] = want
    finally:
        image.close()
    return out


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_port_on_every_mix(name):
    cell = spec.cell(name)
    work = traffic.make(cell.config, mix(cell), 2**31 + 77, "cpu",
                        n_bytes=IMAGE)
    stream = work.stream()
    keywords = {work.keywords[next(stream)] for _ in range(5)}
    keywords.add(work.warm)
    keywords.add(work.keywords[next(p.keyword for p in work.plants
                                    if p.decoy)])
    found = agree(cell.config, work.image, sorted(keywords))
    assert sum(len(r) for r in found.values()) >= len(keywords)


def config_of(width, big, seq=""):
    return {"search_config": {
        "element_width": width, "endianness": "big" if big else "little",
        "custom_char_seq": seq, "preferred_search_block_size": 1 << 19,
        "preferred_preview_width": 50, "semantics": "greedy"}}


def noise(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def test_greedy_suppresses_overlapping_matches():
    data = noise(3 << 20)
    at = (1 << 20) + 5
    data[at : at + 8] = np.frombuffer(b"abababab", np.uint8) + 3
    found = agree(config_of(1, False), data, ["ababa"])["ababa"]
    offsets = [r[0] for r in found]
    assert at in offsets and at + 2 not in offsets


@pytest.mark.parametrize("big", [True, False])
def test_block_fit_filter_at_16_bits(big):
    seq = "あいうえおかきくけこ"
    config = config_of(2, big, seq)
    data = noise(3 << 20, seed=4)
    block = 1 << 19
    kw = "かいけお"
    values = traffic.keyword_values(kw, seq) + 300
    kept, dropped = 2 * block - 3, 3 * block - 1
    for off in (kept, dropped):
        data[off : off + 8] = traffic.encode(values, 2, big)
    found = [r[0] for r in agree(config, data, [kw])[kw]]
    assert kept in found and dropped not in found


def test_ascii_at_16_bits_little_endian():
    config = config_of(2, False)
    data = noise(2 << 20, seed=5)
    values = traffic.keyword_values("dragon", "") + 900
    data[777 : 777 + 12] = traffic.encode(values, 2, False)
    found = agree(config, data, ["dragon"])["dragon"]
    assert [r[0] for r in found] == [777]


def test_wrapped_decoy_is_no_match_but_wraps_under_the_control():
    config = config_of(1, False)
    data = noise(2 << 20, seed=6)
    kw = "sword"
    values = traffic.keyword_values(kw, "")
    shift = 256 - int(values.max())  # 'w' wraps to 0, 's' does not
    data[4096 : 4096 + 5] = (values + shift) % 256
    found = agree(config, data, [kw])[kw]
    assert 4096 not in [r[0] for r in found]
    grids = check.reference_grids(data, config, "cpu")
    wrapped = check.reference_results(grids, config, kw, compare="wrap")
    assert 4096 in [r[0] for r in wrapped]
