"""Refine's share of its roofline: the least time the card could take for
the work the sampled ticks' plans need (``work.tick_work``: rows and norms
of each distinct kept record once a tick, 8 bytes of tags for each live
record of each distinct planned partition once a tick, the plan, the
queries and the answers; 2n + 3 operations a kept pair; bytes over
3.35 TB/s or operations over 67 TFLOP/s), over the device time of every
operation that ran inside those ticks' ``query.refine`` spans, in percent.
The count is the reference's, so the store's padded width does not enter
it.  None where the card has no entry in the table of peaks."""


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


CASE = {"record": {"trace": {"stage_device_s": {
                       "query.refine": [0.004] * 250 + [0.006] * 250}},
                   "refine_work": {"ticks": [0, 499], "bound_s": [0.001, 0.003]}},
        "value": (0.001 + 0.003) / (0.004 + 0.006) * 100, "needs_trace": True,
        # a card without an entry in the table of peaks
        "silent": [{"refine_work": {"ticks": [0], "bound_s": [None]}}]}
