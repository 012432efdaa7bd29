"""The traced run's reduction on a hand-made profile: device operations go
to the stage whose span was open when the host launched them, ranges drawn
on the device's timeline are no operations, and idle gaps go to the
innermost span open at their middle."""
import pytest
from torch.autograd import DeviceType

from climbench import trace

CPU, GPU = DeviceType.CPU, DeviceType.CUDA


class Event:
    def __init__(self, name, start, end, dev=CPU, corr=0, annotation=False):
        self._v = (name, start, end - start, dev, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class Profile:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


EVENTS = [
    Event(trace.WINDOW, 0, 1000), Event("serve.tick", 100, 600),
    Event("query.featurize", 100, 200), Event("query.plan", 200, 400),
    Event("query.refine", 400, 550),
    Event("cudaLaunchKernel", 110, 112, corr=1),
    Event("cudaLaunchKernel", 210, 212, corr=2),
    Event("cudaLaunchKernel", 390, 392, corr=3),
    Event("cudaLaunchKernel", 410, 411, corr=4),
    Event("cudaMemcpyAsync", 560, 561, corr=5),
    Event("paa_kernel", 120, 150, GPU, 1),
    Event("sort_kernel", 215, 250, GPU, 2),
    # launched inside plan, shown starting after refine's range opened
    Event("gather_kernel", 401, 405, GPU, 3),
    Event("refine_partial_kernel", 412, 540, GPU, 4),
    Event("Memcpy DtoH (Device -> Pageable)", 565, 580, GPU, 5),
    Event("query.plan", 200, 400, GPU, 0, annotation=True),
]


def test_reduce_by_hand():
    s = trace.reduce(Profile(EVENTS))
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx((30 + 35 + 4 + 128 + 15) * 1e-9)
    assert s["stage_kernels"] == {"query.featurize": [1], "query.plan": [2],
                                  "query.refine": [1]}
    assert s["stage_device_s"]["query.plan"] == [pytest.approx(39e-9)]
    assert s["stage_device_s"]["query.refine"] == [pytest.approx(128e-9)]
    idle = {k: round(v * 1e9) for k, v in s["idle_by_span"].items()}
    assert idle == {trace.OUTSIDE: 120 + 420, "query.featurize": 65,
                    "query.plan": 151, "query.refine": 7, "serve.tick": 25}
    assert "query.plan" not in s["device_ops"]
    assert s["launch_share"] == 1.0


def test_breakdown_keeps_the_top_entries():
    s = trace.reduce(Profile(EVENTS))
    b = trace.breakdown(s, top=2)
    assert [n for n, _ in b["device_ops"]] == ["refine_partial_kernel", "sort_kernel"]
    assert b["idle_gaps"][0][0] == trace.OUTSIDE
