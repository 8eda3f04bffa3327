"""The reference made slice by slice: with the slice lowered to 64 Ki
window starts its results equal those of one slice over the whole test
image, at 8 bits and at 16 bits in both byte orders, with matches that
straddle a slice border and a GREEDY suppression across one, under both
the signed comparison and the control's wrapped one."""

import numpy as np
import pytest

from benchmark import check, reference, traffic

SMALL = 1 << 16
SEQ = "あいうえおかきくけこ"


def config_of(width, big, seq=""):
    return {"search_config": {
        "element_width": width, "endianness": "big" if big else "little",
        "custom_char_seq": seq, "preferred_search_block_size": 1 << 19,
        "preferred_preview_width": 50, "semantics": "greedy"}}


def plant(data, element, align, values, width, big):
    """Write *values* as elements from element *element* of alignment
    *align*; returns the byte offset."""
    at = align + element * width
    raw = traffic.encode(values, width, big)
    data[at : at + len(raw)] = raw
    return at


def results(config, data, keywords, compare, slice_elems, monkeypatch):
    monkeypatch.setattr(reference, "SLICE_ELEMS", slice_elems)
    grids = check.reference_grids(data, config, "cpu")
    return {kw: check.reference_results(grids, config, kw, compare)
            for kw in keywords}


CASES = [(1, False, ""), (2, True, SEQ), (2, False, SEQ)]


@pytest.mark.parametrize("compare", ["signed", "wrap"])
@pytest.mark.parametrize("width,big,seq", CASES,
                         ids=["u8", "u16be", "u16le"])
def test_slices_give_the_results_of_one_slice(width, big, seq, compare,
                                              monkeypatch):
    config = config_of(width, big, seq)
    data = np.random.default_rng(11).integers(
        0, 256, (7 * SMALL + 123) * width, dtype=np.uint8)
    top = (1 << (8 * width)) - 1
    if seq:
        word, repeat, base = "かいけおう", "あかあかあかあか", 300
    else:
        word, repeat, base = "dragon", "abababab", 0
    values = traffic.keyword_values(word, seq) + base
    rep = traffic.keyword_values(repeat, seq) + base
    expect = {word: set(), repeat[:5]: set()}
    for align in range(width):
        first = 3 * SMALL * align  # each alignment's plants apart
        # a window that starts in one slice and ends in the next, and one
        # that starts on a slice's first window
        expect[word].add(plant(data, first + SMALL - 3, align, values,
                               width, big))
        expect[word].add(plant(data, first + 3 * SMALL, align, values,
                               width, big))
        # windows two elements apart on either side of a border: the first
        # is kept and suppresses the second (GREEDY)
        expect[repeat[:5]].add(plant(data, first + 2 * SMALL - 1, align, rep,
                                     width, big))
    # a wrapped copy: a match only for the control
    wrapped = (values + (top + 1 - int(values.max()))) % (top + 1)
    decoy = plant(data, SMALL // 2, 0, wrapped, width, big)
    keywords = sorted(expect)

    whole = results(config, data, keywords, compare, reference.SLICE_ELEMS,
                    monkeypatch)
    sliced = results(config, data, keywords, compare, SMALL, monkeypatch)
    assert sliced == whole
    for kw, offsets in expect.items():
        found = {r[0] for r in sliced[kw]}
        assert offsets <= found, kw
        if kw == repeat[:5]:
            # the suppressed window two elements after each kept one
            assert not {o + 2 * width for o in offsets} & found
    assert (decoy in {r[0] for r in sliced[word]}) is (compare == "wrap")


def test_a_slice_holds_at_most_its_window_starts_and_a_halo(monkeypatch):
    monkeypatch.setattr(reference, "SLICE_ELEMS", SMALL)
    seen = []
    real = reference._diffs

    def spy(raw, width, big_endian):
        seen.append(raw.numel() // width)
        return real(raw, width, big_endian)

    monkeypatch.setattr(reference, "_diffs", spy)
    config = config_of(2, True, SEQ)
    data = np.random.default_rng(12).integers(0, 256, 10 * SMALL,
                                              dtype=np.uint8)
    grids = check.reference_grids(data, config, "cpu")
    check.reference_results(grids, config, "かいけおう")
    assert max(seen) == SMALL + 5 - 1
    assert len(seen) == 2 * 5  # two alignments of 5 * SMALL elements
