"""What the index's store holds on the card per byte of live records: the
program's ``index.store_bytes`` gauge (every tensor of the store) over its
``index.store_live_bytes`` (each live record's row, norm, tag and id),
both set by ``build_index``.  A dense store pads every partition to the
fullest; a ragged one reads 1 plus its offsets."""


def read(record):
    gauges = (record.get("registry") or {}).get("gauges", {})
    total, live = gauges.get("index.store_bytes"), gauges.get("index.store_live_bytes")
    return total / live if total is not None and live else None


CASE = {"record": {"registry": {"histograms": {}, "counters": {},
                                "gauges": {"index.store_bytes": 2.2e10,
                                           "index.store_live_bytes": 1.0e10}}},
        "value": 2.2, "needs_trace": False,
        "silent": [{"registry": {"histograms": {}, "gauges": {}, "counters": {}}},
                   {"registry": {"histograms": {}, "counters": {},
                                 "gauges": {"index.store_bytes": 2.2e10}}}]}
