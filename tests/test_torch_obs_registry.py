"""The port's metrics registry and health monitor held to the JAX package's.

One scripted sequence of metric events (counters, gauges, histograms and
their labeled twins, with label values that need escaping and help text
with a newline and a backslash) goes through both packages' registries:
the Prometheus text must be byte-identical.  ``install_standard_metrics``
must register the same names with the same types, and one stream of
scores and statistics must get the same verdicts from both packages'
``HealthMonitor`` (anomaly kinds, iterations and facts exact: both sides
compute in Python floats).
"""

import math

import numpy as np
import pytest

from deeplearning4j_tpu.obs import flight_recorder as jflight
from deeplearning4j_tpu.obs import health as jhealth
from deeplearning4j_tpu.obs import registry as jregistry

from deeplearning4j_tpu_torch.obs import flight_recorder, health, registry

SEED = 20261018


def _events(rng):
    """One seeded sequence of metric events as (kind, name, args, labels)."""
    values = rng.normal(scale=3.0, size=64)
    times = np.abs(rng.lognormal(mean=-5.0, sigma=2.0, size=64))
    sizes = rng.integers(1, 2 ** 34, size=16)
    events = []
    for i, v in enumerate(values[:24]):
        events.append(("counter", "tpudl_serve_batches_total", (abs(float(v)),), {}))
        events.append(("gauge", "tpudl_serve_queue_depth", (float(v),), {}))
    for i, t in enumerate(times):
        events.append(("histogram", "tpudl_serve_latency_seconds", (float(t),), {}))
        status = ("ok", "error", 'we"ird\\lab\nel')[i % 3]
        events.append(("labeled_counter", "tpudl_serve_requests_total", (1.0,),
                       {"status": status}))
        events.append(("labeled_histogram", "tpudl_perf_step_seconds", (float(t),),
                       {"program": f"serve:{i % 4}"}))
    for i, s in enumerate(sizes):
        events.append(("byte_histogram", "tpudl_device_transfer_bytes", (float(s),), {}))
        events.append(("labeled_gauge", "tpudl_serve_model_version", (int(s) % 7,),
                       {"model": f"m{i % 3}"}))
    events.append(("gauge", "tpudl_obs_special", (math.inf,), {}))
    events.append(("gauge", "tpudl_obs_integral", (1e15,), {}))
    events.append(("gauge", "tpudl_obs_small", (1e-300,), {}))
    return events


def _play(mod, events) -> str:
    reg = mod.MetricsRegistry()
    helps = {"tpudl_serve_batches_total": "Batches\nwith a back\\slash",
             "tpudl_serve_latency_seconds": "Latency"}
    for kind, name, args, labels in events:
        h = helps.get(name, "")
        if kind == "counter":
            reg.counter(name, h).inc(*args)
        elif kind == "gauge":
            reg.gauge(name, h).set(*args)
        elif kind == "histogram":
            reg.histogram(name, h).observe(*args)
        elif kind == "byte_histogram":
            reg.histogram(name, h, buckets=mod.DEFAULT_BYTE_BUCKETS).observe(*args)
        elif kind == "labeled_counter":
            reg.labeled_counter(name, h).inc(*args, **labels)
        elif kind == "labeled_gauge":
            reg.labeled_gauge(name, h).set(*args, **labels)
        elif kind == "labeled_histogram":
            reg.labeled_histogram(name, h).observe(*args, **labels)
    return reg.render_prometheus()


def test_same_events_render_byte_identical_text():
    events = _events(np.random.default_rng(SEED))
    ours, theirs = _play(registry, events), _play(jregistry, events)
    assert ours == theirs
    assert '\\"' in ours and "\\\\" in ours and 'le="+Inf"' in ours


def test_registration_conflicts_raise_alike():
    for mod in (registry, jregistry):
        reg = mod.MetricsRegistry()
        reg.counter("tpudl_serve_x_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("tpudl_serve_x_total")
        with pytest.raises(ValueError, match="convention"):
            reg.counter("not_a_tpudl_name")
        reg.histogram("tpudl_serve_h_seconds", buckets=(1.0, 2.0))
        with pytest.raises(ValueError, match="buckets"):
            reg.histogram("tpudl_serve_h_seconds", buckets=(1.0,))


def test_standard_metrics_have_the_same_names_and_types():
    ours = registry.install_standard_metrics(registry.MetricsRegistry())
    theirs = jregistry.install_standard_metrics(jregistry.MetricsRegistry())
    assert sorted(ours) == sorted(theirs)
    assert {n: type(m).__name__ for n, m in ours.items()} == \
        {n: type(m).__name__ for n, m in theirs.items()}
    serving = [n for n in ours if n.startswith(("tpudl_serve_", "tpudl_online_",
                                                "tpudl_router_", "tpudl_health_"))]
    assert len(serving) > 20


def test_set_registry_isolates_and_restores():
    mine = registry.MetricsRegistry()
    prev = registry.set_registry(mine)
    try:
        assert registry.get_registry() is mine
    finally:
        assert registry.set_registry(prev) is mine
    assert registry.get_registry() is prev


def test_record_device_memory_is_none_on_the_cpu():
    reg = registry.MetricsRegistry()
    assert registry.record_device_memory(reg, device="cpu") is None
    assert reg.names() == []


def _score_stream(rng):
    """Losses with a spike, a NaN and a recovery, and two stats dicts."""
    losses = list(1.0 + 0.01 * rng.normal(size=30))
    losses[20] = 40.0
    losses[25] = float("nan")
    stats = [
        {"gradients": {"0": {"norm": 3e4, "zero_fraction": 0.99},
                       "1": {"norm": 2.0, "zero_fraction": 0.1}},
         "params": {"0": {"mean_magnitude": 1.0}}, "updates": {"0": {"mean_magnitude": 0.9}}},
        {"gradients": {"0": {"norm": 1e-12}, "1": {"norm": 1e-12}},
         "params": {"1": {"mean_magnitude": 1.0}}, "updates": {"1": {"mean_magnitude": 1e-9}}},
        {"gradients": {"0": {"norm": float("inf")}}},
    ]
    return losses, stats


def _verdicts(mod, flight, reg_mod, losses, stats):
    prev = reg_mod.set_registry(reg_mod.MetricsRegistry())
    flight.get_recorder().clear()
    try:
        mon = mod.HealthMonitor(config=mod.HealthConfig(min_samples=8), frequency=1)
        for i, loss in enumerate(losses):
            mon.iteration_done(None, i, 0, loss)
        for i, st in enumerate(stats):
            mon.stats_ready(None, 100 + i, 0, 0.0, st)
        text = reg_mod.get_registry().render_prometheus()
        events = [{k: v for k, v in e.items() if k not in ("t", "mono")}
                  for e in flight.get_recorder().events() if e["kind"] == "health"]
    finally:
        reg_mod.set_registry(prev)
        flight.get_recorder().clear()
    return [{k: v for k, v in a.items() if k != "time"} for a in mon.anomalies], text, events


def test_health_monitor_gives_the_same_verdicts():
    losses, stats = _score_stream(np.random.default_rng(SEED + 1))
    ours = _verdicts(health, flight_recorder, registry, losses, stats)
    theirs = _verdicts(jhealth, jflight, jregistry, losses, stats)
    assert ours == theirs
    kinds = [a["kind"] for a in ours[0]]
    assert kinds == ["loss_spike", "non_finite_loss", "grad_explosion", "dead_units",
                     "update_ratio", "grad_vanish", "update_ratio", "non_finite_grad"]


def test_robust_zscore_and_stragglers_agree():
    rng = np.random.default_rng(SEED + 2)
    for _ in range(20):
        window = list(rng.normal(size=int(rng.integers(0, 12))))
        value = float(rng.normal(scale=5.0))
        assert health.robust_zscore(window, value) == jhealth.robust_zscore(window, value)
    assert health.robust_zscore([1.0, 1.0, 1.0], 1.0) is None
    medians = {f"w{i}": float(m) for i, m in enumerate(rng.uniform(0.05, 0.1, size=6))}
    medians["w6"], medians["w7"] = 0.5, None
    assert health.stragglers(medians) == jhealth.stragglers(medians) == ["w6"]


def test_halt_action_raises_health_halt():
    mon = health.HealthMonitor(actions=("halt",))
    with pytest.raises(health.HealthHalt) as err:
        mon.iteration_done(None, 0, 0, float("nan"))
    assert err.value.kind == "non_finite_loss"
    with pytest.raises(ValueError, match="checkpoint_listener"):
        health.HealthMonitor(actions=("checkpoint",))


def test_concurrent_updates_lose_no_count():
    """More threads than cores hammer one counter, one labeled counter and
    one histogram with a short switch interval: no update may be lost."""
    import os
    import sys
    import threading
    reg = registry.MetricsRegistry()
    threads, per = max(8, 2 * (os.cpu_count() or 1)), 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(per):
                reg.counter("tpudl_serve_batches_total").inc()
                reg.labeled_counter("tpudl_serve_requests_total").inc(status=("ok", "error")[i % 2])
                reg.histogram("tpudl_serve_latency_seconds").observe(1e-3)

        workers = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    total = threads * per
    assert reg.counter("tpudl_serve_batches_total").value == total
    requests = reg.labeled_counter("tpudl_serve_requests_total")
    assert requests.labeled_value(status="ok") + requests.labeled_value(status="error") == total
    assert reg.histogram("tpudl_serve_latency_seconds").count == total
