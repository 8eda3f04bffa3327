"""A keyword batch as one request: one ``MultiSearcher`` over the image,
made once, with the configuration's ``SearchConfig`` fields, then
``search(entry, generate_previews=True)`` for each stream entry (a tuple
of keywords)."""


def make(config: dict, path: str, device, search_config_overrides: dict):
    """A function of one entry that searches the image at *path* for all
    of its keywords and returns ``(last_stats, [(keyword, result), ...])``,
    the results keyword by keyword in the entry's order.  A searcher that
    keeps no ``last_stats`` gives an empty ``SearchStats``, so that the
    readers of the stats read zeros where they would fail."""
    from benchmark.harness import search_config
    from monkey_moore_tpu_torch.multi import MultiSearcher
    from monkey_moore_tpu_torch.profiling import SearchStats

    sc = search_config(config, "", path, search_config_overrides)
    searcher = MultiSearcher(
        path, element_width=sc.element_width, endianness=sc.endianness,
        preferred_search_block_size=sc.preferred_search_block_size,
        device_chunk_bytes=sc.device_chunk_bytes,
        preferred_preview_width=sc.preferred_preview_width,
        semantics=sc.semantics, resident_bytes_limit=sc.resident_bytes_limit,
        device=device)

    def request(entry):
        lists = searcher.search(list(entry), generate_previews=True)
        stats = getattr(searcher, "last_stats", None) or SearchStats()
        return stats, [(kw, r) for kw, rs in zip(entry, lists) for r in rs]

    return request


def as_tuples(results) -> list:
    """A request's results as ``references/batch.py``'s tuples:
    ``((keyword, byte offset), values map, preview)``.  The program's are
    ``(keyword, SearchResult)`` pairs; the control's (``control.py``, the
    reference put in the program's place) are results whose offset is
    already the ``(keyword, offset)`` key."""
    out = []
    for item in results:
        if isinstance(item, tuple) and len(item) == 2:
            keyword, r = item
            key = (str(keyword), int(r.offset))
        else:
            r = item
            key = (str(r.offset[0]), int(r.offset[1]))
        out.append((key, {int(k): int(v) for k, v in r.values_map.items()},
                    str(r.preview)))
    return out
