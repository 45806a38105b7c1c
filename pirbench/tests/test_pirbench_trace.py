"""The trace's reduction with the program's own ranges in the profile
(``repro_torch.serve.spans``, named ``repro_torch.<stage>[#k]``), on
synthetic profiler events and on a tiny traced run: they stay apart from
the benchmark's ranges and from the device operations, so every reader
reads what it reads without them."""

import types

import pytest
from torch.autograd import DeviceType

from pirbench import harness
from pirbench import trace as tracing

EXISTING = ("batch_fill.p95", "plan_device_ms.p95", "answer_roofline.p95",
            "device_idle.p95")


class Event:
    """What ``reduce_profile`` reads of one kineto event (times in s)."""

    def __init__(self, name, start, end, tid=1, device=False, corr=0,
                 annotation=False):
        self._name, self._tid, self._corr = name, tid, corr
        self._start, self._dur = int(start * 1e9), int((end - start) * 1e9)
        self._dev = DeviceType.CUDA if device else DeviceType.CPU
        self._annotation = annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._annotation

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_resource_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr


def profile_of(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def bench_events():
    """A window with one planned and one answered batch: the benchmark's
    ranges, launches and kernels."""
    return [
        Event("pirbench.window", 0.0, 10.0, tid=1),
        Event("pirbench.plan#0", 1.0, 2.0, tid=7),
        Event("cudaLaunchKernel", 1.2, 1.21, tid=7, corr=1),
        Event("rank_kernel", 1.3, 1.5, tid=0, device=True, corr=1),
        Event("pirbench.answer#0", 3.0, 5.0, tid=8),
        Event("cudaLaunchKernel", 3.1, 3.11, tid=8, corr=2),
        Event("gather_xor_kernel", 3.2, 4.0, tid=0, device=True, corr=2),
        Event("cudaLaunchKernel", 4.1, 4.11, tid=8, corr=3),
        Event("gather_xor_kernel", 4.2, 4.6, tid=0, device=True, corr=3),
        Event("pirbench.plan#0", 1.3, 1.5, tid=0, device=True,
              annotation=True),
    ]


def program_events():
    """The program's own ranges over the same batch, the launches inside
    them, and their mirrors on the device's timeline."""
    return [
        Event("repro_torch.plan#4", 0.9, 2.1, tid=7),
        Event("repro_torch.plan.route", 1.1, 1.6, tid=7),
        Event("repro_torch.front.settle#3", 2.2, 5.2, tid=7),
        Event("repro_torch.execute#4", 2.9, 5.1, tid=8),
        Event("repro_torch.answer#4", 3.05, 4.95, tid=8),
        Event("repro_torch.answer.sparse_pair", 3.05, 4.05, tid=8),
        Event("repro_torch.answer.sparse_pair", 4.05, 4.9, tid=8),
        Event("repro_torch.front.idle", 5.3, 9.0, tid=7),
        Event("repro_torch.plan#4", 1.3, 1.5, tid=0, device=True,
              annotation=True),
        Event("repro_torch.answer#4", 3.2, 4.6, tid=0, device=True,
              annotation=True),
    ]


def ctx_of(tr):
    return types.SimpleNamespace(
        trace=tr, cell=None, answer_least={0: 0.5},
        counters={"queries": 8, "cache_hits": 0, "padded": 0})


def read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_program_ranges_stay_out_of_ranges_ownership_and_ops():
    tr = tracing.reduce_profile(profile_of(bench_events() + program_events()))
    assert [(r.layer, r.seq) for r in tr.ranges] == [
        ("window", -1), ("plan", 0), ("answer", 0)]
    assert sorted(o.name for o in tr.ops) == [
        "gather_xor_kernel", "gather_xor_kernel", "rank_kernel"]
    # a kernel launched inside a program range still belongs to the
    # benchmark's range around it
    assert {(o.name, o.owner.layer, o.owner.seq) for o in tr.ops} == {
        ("rank_kernel", "plan", 0), ("gather_xor_kernel", "answer", 0)}
    assert tr.device_s("plan") == {0: pytest.approx(0.2)}
    assert tr.device_s("answer") == {0: pytest.approx(1.2)}


def test_program_ranges_leave_every_existing_reader_as_it_was():
    plain = tracing.reduce_profile(profile_of(bench_events()))
    both = tracing.reduce_profile(profile_of(bench_events()
                                             + program_events()))
    for name in EXISTING:
        want = read(name, ctx_of(plain))
        assert want is not None, name
        assert read(name, ctx_of(both)) == want, name
    assert plain.busy_s == both.busy_s
    assert plain.top_ops() == both.top_ops()
    assert plain.idle_gaps() == both.idle_gaps()
    assert plain.unlinked == both.unlinked


def test_a_traced_tiny_run_with_the_programs_ranges_on(monkeypatch):
    from _tiny import run_tiny
    from repro_torch.serve import spans

    opened = []
    record = spans._record

    def counting(name):
        opened.append(name)
        return record(name)

    monkeypatch.setattr(spans, "_record", counting)
    spans.enable(True)
    try:
        res = run_tiny("ct_chor.online", trace=True)
    finally:
        spans.enable(False)
    assert res["correct"], res["limits"]
    stages = {n.split("#")[0] for n in opened}
    assert {"repro_torch.plan", "repro_torch.execute",
            "repro_torch.answer", "repro_torch.front.settle"} <= stages
    assert 0 < res["metrics"]["batch_fill.p50"]["value"] <= 100
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
