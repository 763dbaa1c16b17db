"""The port's decode-path spans (libheif_tpu_torch/core/trace.py)."""

import time

import pytest

torch = pytest.importorskip("torch")

from libheif_tpu_torch.core import trace  # noqa: E402


def test_span_outside_collect_records_nothing():
    with trace.span("outside"):
        pass
    assert trace._totals is None


def test_spans_sum_by_name_and_nest_inclusively():
    with trace.collect() as spans:
        with trace.span("outer"):
            for _ in range(3):
                with trace.span("inner"):
                    time.sleep(0.002)
    assert spans["inner"]["count"] == 3 and spans["outer"]["count"] == 1
    assert spans["outer"]["ms"] >= spans["inner"]["ms"] >= 6.0


def test_collect_nests_and_restores():
    with trace.collect() as outer:
        with trace.collect() as inner:
            with trace.span("a"):
                pass
        with trace.span("b"):
            pass
    assert set(inner) == {"a"} and set(outer) == {"b"}
    assert trace._totals is None


def test_span_counts_a_raising_part():
    with trace.collect() as spans:
        with pytest.raises(ValueError):
            with trace.span("fails"):
                raise ValueError("x")
    assert spans["fails"]["count"] == 1


def test_span_is_a_profiler_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("av1.test_range"):
            torch.ones(4).sum()
    assert any(e.name == "av1.test_range" for e in prof.events())


def test_spans_from_many_threads_lose_no_update():
    """Spans ending on several threads at once (a grid's tile parses)
    all count: more threads than cores, a short switch interval."""
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor
    workers, per = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.collect() as spans:
            def run(_):
                for _ in range(per):
                    with trace.span("threaded"):
                        pass
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(run, range(workers), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert spans["threaded"]["count"] == workers * per
