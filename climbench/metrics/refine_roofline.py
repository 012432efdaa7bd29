"""Refine's share of its roofline: the least time the card could take for
the work the sampled ticks' plans need (``work.tick_work``: rows and norms
of each distinct kept record once a tick, the tags of every live plan slot,
the plan, the queries and the answers; 2n + 3 operations a kept pair;
bytes over 3.35 TB/s or operations over 67 TFLOP/s), over the device time
of every operation that ran inside those ticks' ``query.refine`` spans, in
percent.  None where the card has no entry in the table of peaks."""


def read(record):
    tr, rw = record["trace"], record["refine_work"]
    if not tr or not rw or any(b is None for b in rw["bound_s"]):
        return None
    spans = tr["stage_device_s"]["query.refine"]
    ticks = [t for t in rw["ticks"] if t < len(spans)]
    device_s = sum(spans[t] for t in ticks)
    if not ticks or device_s <= 0:
        return None
    bound = sum(b for t, b in zip(rw["ticks"], rw["bound_s"]) if t < len(spans))
    return bound / device_s * 100.0
