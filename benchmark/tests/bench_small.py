"""Test sizes of the cells: small images on the kernels' plain versions."""

import json

#: image bytes of a test run
IMAGE = 4 << 20
#: the port's knobs at test sizes: several chunks, and the device route
#: (the configurations' images ride it at full size)
PORT = {"device_chunk_bytes": 1 << 20, "host_latency_threshold_bytes": 0}
CELLS = ["u8_sparse", "u16be_kana", "u8_dense", "u8_open"]


def traffic_over(cell) -> dict:
    """Mix parameters cut to a test image."""
    over = {}
    if cell.traffic.get("script"):
        over["script"] = dict(cell.traffic["script"], bytes=512 << 10,
                              within_bytes=2 << 20)
    if cell.traffic["keywords"]["from"] == "sequence":
        over["keywords"] = dict(cell.traffic["keywords"], count=32)
    return over


def overrides(cell) -> dict:
    return json.loads(json.dumps({"image_bytes": IMAGE, "search_config": PORT,
                                  "traffic": traffic_over(cell)}))


def mix(cell) -> dict:
    out = dict(cell.traffic)
    out.update(traffic_over(cell))
    return out
