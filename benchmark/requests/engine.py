"""The request of a mix that names none: one ``SearchEngine`` for one
keyword with the configuration's ``SearchConfig``, then
``run(generate_previews=True)``."""


def make(config: dict, path: str, device, search_config_overrides: dict):
    """A function of one keyword that searches the image at *path* and
    returns ``(engine.last_stats, results)``."""
    from benchmark.harness import search_config
    from monkey_moore_tpu_torch.engine import SearchEngine

    def request(keyword: str):
        engine = SearchEngine(
            search_config(config, keyword, path, search_config_overrides),
            device=device)
        results = engine.run(generate_previews=True)
        return engine.last_stats, results

    return request
