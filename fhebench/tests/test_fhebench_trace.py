"""The reduction of a traced slice, on synthetic profiler events: busy time
as the union of device intervals, the markers pairing with the marked spans,
per-call device time, idle gaps labelled by the innermost host span."""

from fhebench import trace as tr

K5 = "void (anonymous namespace)::keyswitch2_fused_kernel<8, 8>((anonymous namespace)::Params)"
ADD = "void at::native::vectorized_elementwise_kernel<2, at::native::CUDAFunctor_add<long>>(int)"
SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def _trace(events, marked):
    spans = tr.Spans()
    spans.host_s["relinearize"], spans.calls["relinearize"] = 0.004, 2
    return tr.Trace(spans, {"keyswitches": 2}, {"n": 8}, events, 100e-6, marked)


EVENTS = [
    ("fhe.request", False, 0.0, 100.0),
    ("fhe.relinearize", False, 1.0, 40.0),
    (SPIN, True, 2.0, 3.0), (K5, True, 10.0, 30.0), (ADD, True, 25.0, 35.0), (SPIN, True, 36.0, 37.0),
    ("fhe.relinearize", False, 50.0, 90.0),
    (SPIN, True, 60.0, 61.0), (K5, True, 70.0, 80.0), (SPIN, True, 81.0, 82.0),
]
MARKED = [("relinearize", {"limbs": 48}), ("relinearize", {"limbs": 47})]


def test_busy_idle_and_kinds():
    t = _trace(EVENTS, MARKED)
    assert abs(t.busy_s() - 35e-6) < 1e-12
    assert abs(t.idle_share_pct() - 65.0) < 1e-9
    assert t.device_ms("own") == 0.03 and t.device_ms("plain") == 0.01
    assert t.per_call(t.device_ms(), "relinearize") == 0.02
    assert abs(t.host_ms_per("keyswitches", "relinearize") - 2.0) < 1e-12


def test_markers_pair_with_the_marked_spans():
    t = _trace(EVENTS, MARKED)
    assert [(n, m["limbs"], ms) for n, m, ms in t.marked] == [("relinearize", 48, 0.03),
                                                             ("relinearize", 47, 0.01)]
    lost = [e for e in EVENTS if not (e[0] == SPIN and e[2] == 81.0)]
    assert _trace(lost, MARKED).marked == []


def test_breakdown_labels_gaps_by_the_innermost_span():
    b = _trace(EVENTS, MARKED).breakdown()
    assert b["device_ops"][0][0].startswith("void (anonymous namespace)::keyswitch2")
    assert [name for name, _ in b["idle_gaps"]] == ["relinearize"]
    assert abs(b["idle_gaps"][0][1] - 35e-6) < 1e-12
    assert all(SPIN not in name for name, _ in b["device_ops"])
