"""The port's tracing, flight recorder and fault plans held to the JAX
package's.

- One scripted tree of spans through both packages' tracers: the same
  names, nesting (parent ids), attributes and Chrome-trace event fields
  (the ids are random and the times are the clock's, so those are held
  by structure: each span's parent is its enclosing span's id).
- A dump written by the port's flight recorder is read by the JAX
  package's ``read_dump``: header, liveness, thread stacks, events (span
  mirrors and notes), metrics and device lines.
- A seeded set of fault specs parses to the same rules in both packages,
  and a seeded event sequence fires (or poisons, or truncates) at the
  same indices.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.obs import flight_recorder as jflight
from deeplearning4j_tpu.obs import tracing as jtracing
from deeplearning4j_tpu.resilience import faults as jfaults

from deeplearning4j_tpu_torch import config
from deeplearning4j_tpu_torch.obs import flight_recorder, tracing
from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, set_registry
from deeplearning4j_tpu_torch.resilience import faults

SEED = 20261018


def _tree(mod):
    """fit -> (epoch 0 -> step, step), (epoch 1 -> step), serve."""
    tracer = mod.Tracer(enabled=True)
    with mod.use_tracer(tracer):
        with mod.span("fit", model="m", epochs=2):
            for e, steps in ((0, 2), (1, 1)):
                with mod.span("epoch", epoch=e) as ep:
                    assert mod.current_span() is ep
                    for i in range(steps):
                        with mod.span("step", i=i, loss=0.5 * i) as st:
                            st.set_attribute("obj", (1, 2))
                            mod.device_sync(np.zeros(2, np.float32)) if mod is jtracing \
                                else mod.device_sync(None)
        with mod.span("serve", rows=3, requests=2):
            pass
        raw = None
        with mod.span("outer") as outer:
            raw = mod.inject()
            ctx = mod.extract(raw)
            assert ctx.span_id == outer.span_id and ctx.trace_id == outer.trace_id
    return tracer


def _shape(tracer):
    spans = tracer.spans
    by_id = {s.span_id: s for s in spans}
    return [(s.name, by_id[s.parent_id].name if s.parent_id else None, s.attributes,
             s.trace_id == by_id[s.parent_id].trace_id if s.parent_id else True)
            for s in spans]


def test_span_tree_matches():
    ours, theirs = _tree(tracing), _tree(jtracing)
    assert _shape(ours) == _shape(theirs)
    assert [s.name for s in ours.spans] == ["step", "step", "epoch", "step", "epoch", "fit",
                                            "serve", "outer"]
    assert len({s.trace_id for s in ours.spans if s.name != "serve"}) == 2


def test_chrome_trace_events_have_the_same_fields(tmp_path):
    ours, theirs = _tree(tracing), _tree(jtracing)
    a = json.loads(open(ours.export_chrome_trace(str(tmp_path / "a.json"))).read())
    b = json.loads(open(theirs.export_chrome_trace(str(tmp_path / "b.json"))).read())
    assert set(a) == set(b) == {"traceEvents", "displayTimeUnit"}
    for ea, eb in zip(a["traceEvents"], b["traceEvents"], strict=True):
        assert set(ea) == set(eb)
        assert (ea["name"], ea["cat"], ea["ph"]) == (eb["name"], eb["cat"], eb["ph"])
        drop = {"span_id", "parent_id", "device_sync_ms"}
        assert {k: v for k, v in ea["args"].items() if k not in drop} == \
            {k: v for k, v in eb["args"].items() if k not in drop}
        assert set(ea["args"]) - {"device_sync_ms"} == set(eb["args"]) - {"device_sync_ms"}


def test_jsonl_export_is_append_only(tmp_path):
    tracer = _tree(tracing)
    path = str(tmp_path / "spans.jsonl")
    tracer.export_jsonl(path)
    tracer.export_jsonl(path)
    rows = [json.loads(line) for line in open(path)]
    assert len(rows) == len(tracer.spans)
    assert set(rows[0]) == set(jtracing.Span("x", "t", "s", None, 0.0).to_dict())


def test_disabled_tracing_yields_the_null_span():
    assert config.get_config().tracing is False
    with tracing.span("off") as sp:
        assert sp is tracing.NULL_SPAN
    config.set_config(tracing=True)
    try:
        tracer = tracing.Tracer()
        with tracing.use_tracer(tracer):
            with tracing.span("on"):
                pass
        assert [s.name for s in tracer.spans] == ["on"]
    finally:
        config.set_config(tracing=False)


def test_device_sync_is_free_on_the_cpu():
    import torch
    x = torch.ones(3)
    with tracing.use_tracer(tracing.Tracer(enabled=True)) as tracer:
        with tracing.span("s") as sp:
            assert tracing.device_sync([x, {"a": x}]) is not None
    assert sp.device_sync_s < 0.05 and tracer.spans[0] is sp
    assert tracing.device_memory_stats("cpu") is None


def test_reference_read_dump_reads_the_port_dump(tmp_path):
    prev = set_registry(MetricsRegistry())
    rec = flight_recorder.get_recorder()
    rec.clear()
    try:
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        get_registry().counter("tpudl_serve_batches_total").inc(3)
        flight_recorder.record("serve_error", model="m", requests=2, error="boom")
        flight_recorder.progress("serve.dispatch", batch=1)
        with tracing.use_tracer(tracing.Tracer(enabled=True)):
            with tracing.span("serve", model="m", rows=4):
                pass
        path = flight_recorder.dump(str(tmp_path / "black_box.jsonl"), reason="test",
                                    detail={"k": 1})
    finally:
        set_registry(prev)
        rec.clear()
    lines = jflight.read_dump(path)
    assert lines == flight_recorder.read_dump(path)
    types = [line["type"] for line in lines]
    assert types[:2] == ["header", "liveness"] and types[-2:] == ["cost_breakdown", "device"]
    assert lines[0]["reason"] == "test" and lines[0]["detail"] == {"k": 1}
    assert lines[1]["last_site"] == "serve.dispatch"
    assert "thread" in types
    events = [line for line in lines if line["type"] == "event"]
    assert [e["kind"] for e in events] == ["serve_error", "progress", "span"]
    span = events[-1]
    assert span["name"] == "serve" and "device_sync_ms" in span
    assert span["attributes"] == {"model": "m", "rows": 4}
    metrics = next(line for line in lines if line["type"] == "metrics")
    assert metrics["values"] == {"tpudl_serve_batches_total": 3.0}
    assert lines[-1]["note"] == "cuda not initialized" or "device_kind" in lines[-1]


def _specs(rng):
    sites = ("serve.dispatch", "trainer.step", "checkpoint.write", "feeder.stage")
    actions = ("error", "crash", "delay", "truncate", "nan")
    specs = []
    for _ in range(12):
        parts = []
        for _ in range(int(rng.integers(1, 4))):
            site, action = sites[rng.integers(len(sites))], actions[rng.integers(len(actions))]
            at, times = int(rng.integers(0, 6)), int(rng.integers(1, 3))
            arg = {"delay": "0", "truncate": "16"}.get(action, "0")
            parts.append(f"{site}@{at}:{action}:{arg}:{times}" if rng.random() < 0.7
                         else f"{site}@{at}:{action}")
        specs.append((";" if rng.random() < 0.5 else ",").join(parts))
    return specs


def _fire_log(mod, spec):
    plan = mod.FaultPlan.parse(spec)
    log = []
    for i in range(8):
        for site in ("serve.dispatch", "trainer.step", "feeder.stage"):
            try:
                plan.fire(site)
                log.append((site, i, "ok"))
            except mod.InjectedCrash:
                log.append((site, i, "crash"))
            except mod.InjectedFault:
                log.append((site, i, "fault"))
            log.append((site, i, plan.poison(site)))
    return [(r.site, r.at, r.action, r.arg, r.times) for r in plan.rules], log


def test_fault_specs_parse_and_fire_alike():
    prev = set_registry(MetricsRegistry())
    try:
        for spec in _specs(np.random.default_rng(SEED)):
            assert _fire_log(faults, spec) == _fire_log(jfaults, spec), spec
    finally:
        set_registry(prev)
    for bad in ("serve.dispatch@x:error", "serve.dispatch@1:error:nope"):
        with pytest.raises(ValueError, match="bad fault rule"):
            faults.FaultPlan.parse(bad)
        with pytest.raises(ValueError, match="bad fault rule"):
            jfaults.FaultPlan.parse(bad)


def test_truncate_corrupts_the_same_files(tmp_path):
    for name, mod in (("ours", faults), ("theirs", jfaults)):
        plan = mod.FaultPlan.parse("checkpoint.write@1:truncate:10")
        sizes = []
        for i in range(3):
            path = tmp_path / f"{name}{i}.bin"
            path.write_bytes(b"x" * 100)
            plan.corrupt("checkpoint.write", str(path))
            sizes.append(path.stat().st_size)
        assert sizes == [100, 90, 100]


def test_inject_scopes_and_clears_the_plan():
    assert faults.get_fault_plan() is None
    with faults.inject("serve.dispatch@1:error") as plan:
        assert faults.get_fault_plan() is plan
        faults.fire("serve.dispatch")
        with pytest.raises(faults.InjectedFault, match=r"serve.dispatch\[1\]"):
            faults.fire("serve.dispatch")
        faults.fire("serve.dispatch")
    assert faults.get_fault_plan() is None
    faults.install_fault_plan(faults.FaultPlan.parse("x@0:crash"))
    faults.clear_fault_plan()
    faults.fire("x")
