"""Wildcard and mixed-case searches through the resident path on the card
equal the same searches on the CPU (the kernels' plain versions): offsets,
values maps and previews, on the small planted file of
``tests/test_torch_wildcard.py`` in 16 KiB chunks and on a 24 MiB one in
the engine's default chunks.

These tests need a CUDA device and ``nvcc``; without a card they skip.  On
the card, run ``python -m pytest tests/test_torch_wildcard_cuda.py -m cuda
-q``.  Tolerance: exact equality throughout.
"""

import pytest
import torch

from monkey_moore_tpu_torch import corpus
from monkey_moore_tpu_torch.config import SearchConfig
from monkey_moore_tpu_torch.engine import SearchEngine
from monkey_moore_tpu_torch.ops import scan_cuda
from wildcard_plants import KEYWORDS, N_BYTES, planted_file

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tuples(results):
    return [(r.offset, r.values_map, r.preview) for r in results]


@pytest.mark.parametrize("n_bytes,chunk", [(N_BYTES, 16_384),
                                           (24 << 20, None)])
@pytest.mark.parametrize("keyword", KEYWORDS)
def test_resident_wildcard_search_cuda_equals_cpu(cuda, tmp_path, keyword,
                                                  n_bytes, chunk):
    path, real = planted_file(tmp_path, keyword, n_bytes)
    knobs = {"device_chunk_bytes": chunk} if chunk else {}
    cfg = SearchConfig(file_path=path, keyword=keyword, wildcard="*",
                       host_latency_threshold_bytes=0, **knobs)
    corpus.clear_corpus_cache()
    scan_cuda.reset_launch_counts()
    engine = SearchEngine(cfg, device="cuda")
    got = engine.run(generate_previews=True)
    assert engine.last_stats.h2d_bytes >= n_bytes  # the resident upload
    assert scan_cuda.launch_counts["tile_counts"] > 0
    assert scan_cuda.launch_counts["hot_combo"] > 0
    corpus.clear_corpus_cache()
    want = SearchEngine(cfg, device="cpu").run(generate_previews=True)
    assert _tuples(got) == _tuples(want)
    assert set(real) <= {r.offset for r in got}
