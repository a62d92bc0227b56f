"""The port's elastic gangs (``resilience.elastic``,
``parallel.mesh.resize_spec``/``resize_layout``,
``ClusterSupervisor.request_resize``) held to the JAX package's.

- ``resize_spec`` and ``resize_layout``'s refusals (``LayoutResizeError``)
  against the reference's, spec by spec;
- ``ResizeCoordinator``'s lifecycle (request, latest-wins, begin, commit,
  no-op, abort) and its ``tpudl_elastic_*`` series against the
  reference's, step by step;
- ``ClusterSupervisor.request_resize`` (the floor refused at once) and
  the grown child's context (width, grown flag);
- one supervised grow from 1 to 2 ranks of ``tests/cluster_workers.py``'s
  dropout net under ``Trainer(layout="dp<width>")`` (the width from the
  launcher context), resumed from the shared verified checkpoint: the
  post-boundary losses and the final params within 1e-6 of a fixed-width
  dp2 run (a gang of 2, run meanwhile) and of the single process;
- a ``gang.grow@0:kill`` drill: the grown slot w1 dies right after its
  restore, and the supervisor recovers by a respawn at width 2, ending
  within 1e-6 of the same runs.
"""

import functools
import threading
import time
import types

import numpy as np
import pytest

import cluster_workers
import torch_cluster_workers as workers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.obs.registry import MetricsRegistry as JMetricsRegistry
from deeplearning4j_tpu.obs.registry import get_registry as jget_registry
from deeplearning4j_tpu.obs.registry import set_registry as jset_registry
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.resilience import elastic as jelastic

from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, get_registry, set_registry
from deeplearning4j_tpu_torch.obs.ui_server import UIServer
from deeplearning4j_tpu_torch.parallel import launcher, mesh
from deeplearning4j_tpu_torch.parallel.launcher import GangHandle
from deeplearning4j_tpu_torch.resilience import elastic
from deeplearning4j_tpu_torch.resilience.elastic import ResizeCoordinator
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy
from deeplearning4j_tpu_torch.resilience.supervisor import ClusterSupervisor
from deeplearning4j_tpu_torch.train import Trainer

GROW_PORT, DRILL_PORT, FIXED_PORT = 14711, 15111, 15311
EXACT = 1e-6
EPOCHS = 4
NO_WAIT = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.array(tree)


@pytest.fixture(scope="module")
def spec():
    """The elastic worker's net: ``run_elastic_reference``'s configuration
    and its initial weights from the JAX package."""
    conf = cluster_workers._supervised_conf(77)
    net = JMultiLayerNetwork(conf).init()
    return {"elastic": {"conf": conf.to_json(), "p0": _np_tree(net.params_),
                        "s0": _np_tree(net.state_)}}


@pytest.fixture
def registries():
    prev, jprev = set_registry(MetricsRegistry()), jset_registry(JMetricsRegistry())
    yield get_registry(), jget_registry()
    set_registry(prev)
    jset_registry(jprev)


@pytest.mark.parametrize("layout,width", [
    ("dp2", 4), ("dp2", 1), ("dp4", 2), ("pp2", 4), ("dp2xtp2", 8), ("dp2xtp2", 5),
    ("pp3", 4), ("dp2xpp2", 8), ("sp2xep2", 8), ("dp2", 0), ("tp4", 4), ("tp4", 2)])
def test_resize_spec_follows_the_reference(layout, width):
    got_spec, want_spec = mesh.MeshSpec.parse(layout), jmesh.MeshSpec.parse(layout)
    try:
        want = jmesh.resize_spec(want_spec, width)
    except jmesh.LayoutResizeError as e:
        with pytest.raises(mesh.LayoutResizeError) as err:
            mesh.resize_spec(got_spec, width)
        assert str(err.value) == str(e)
        assert isinstance(err.value, ValueError)
        return
    got = mesh.resize_spec(got_spec, width)
    assert got.sizes() == want.sizes() and got.describe() == want.describe()


def test_resize_layout_refuses_before_building_and_needs_the_new_group():
    # a layout whose axes stay fixed: the typed refusal comes first
    pp3 = types.SimpleNamespace(spec=mesh.MeshSpec.parse("pp3"), tp_family="dense")
    with pytest.raises(mesh.LayoutResizeError, match="3 stages"):
        mesh.resize_layout(pp3, 4)
    with pytest.raises(jmesh.LayoutResizeError, match="3 stages"):
        jmesh.resize_layout(jmesh.MeshLayout(jmesh.MeshSpec(pipe=3)), 4)
    # a width it allows: the new layout needs the relaunched gang's group
    dp1 = types.SimpleNamespace(spec=mesh.MeshSpec(data=1), tp_family="dense")
    with pytest.raises(RuntimeError, match="spawn_local_cluster"):
        mesh.resize_layout(dp1, 2, devices="cpu")
    # the in-process resize needs a layout, as the reference's
    with pytest.raises(ValueError, match="layout"):
        Trainer(workers.dense_net()).request_resize(2)


def test_resize_coordinator_lifecycle_and_metrics_follow_the_reference(registries):
    reg, jreg = registries
    got_events, want_events = [], []
    rcs = (ResizeCoordinator(width=2, min_width=1, on_event=got_events.append),
           jelastic.ResizeCoordinator(width=2, min_width=1, on_event=want_events.append))
    for rc in rcs:
        with pytest.raises(ValueError):
            rc.request(0)
    with pytest.raises(ValueError, match="training floor"):
        ResizeCoordinator(width=4, min_width=2).request(1)
    with pytest.raises(ValueError, match="training floor"):
        jelastic.ResizeCoordinator(width=4, min_width=2).request(1)
    with pytest.raises(ValueError, match=">= 1"):
        ResizeCoordinator(width=0)

    def run(rc):
        d1 = rc.request(4, reason="spike")
        seen = [(d1.kind, rc.pending() is d1, rc.width)]
        d2 = rc.request(3)                  # the latest wins over one not begun
        begun = rc.begin()
        seen.append((begun is d2, rc.in_flight() is d2, rc.pending()))
        with pytest.raises(ValueError, match="in flight"):
            rc.request(4)
        rc.commit(begun)
        seen.append((rc.width, begun.outcome, begun.flip_s is not None))
        noop = rc.request(3)
        seen.append((noop.outcome, rc.pending()))
        rc.request(2)
        d3 = rc.begin()
        rc.abort(d3, reason="relaunch failed")
        seen.append((rc.width, d3.outcome, d3.reason))
        with pytest.raises(ValueError):
            rc.commit(d3)
        seen.append([(d.kind, d.from_width, d.to_width, d.outcome, d.seq) for d in rc.history])
        seen.append([d.summary() for d in rc.history])
        return seen

    assert run(rcs[0]) == run(rcs[1])
    assert [d.summary() for d in got_events] == [d.summary() for d in want_events]
    for name in ("tpudl_elastic_grows_total", "tpudl_elastic_shrinks_total"):
        assert reg.counter(name).value == jreg.counter(name).value
    assert reg.gauge("tpudl_elastic_gang_width").value == 3 == \
        jreg.gauge("tpudl_elastic_gang_width").value
    assert reg.histogram("tpudl_elastic_flip_seconds").count == \
        jreg.histogram("tpudl_elastic_flip_seconds").count == 1


def test_request_resize_and_the_grown_childs_context(tmp_path):
    sup = ClusterSupervisor(workers.trivial_worker, n_processes=2, min_workers=2,
                            checkpoint_dir=str(tmp_path))
    assert sup.width == 2
    with pytest.raises(ValueError, match="training floor"):
        sup.request_resize(1)
    sup.request_resize(4, reason="test")
    assert sup._resize.pending().to_width == 4
    ctx = sup._child_env(1, [0, 1, 2, 3], None, grown=True)(2)
    assert (ctx["gang_width"], ctx["grown"], ctx["worker"]) == (4, True, "w2")
    ctx = sup._child_env(0, [0, 1], None)(0)
    assert (ctx["gang_width"], ctx["grown"]) == (2, False)
    # the child's side reads them from its launcher context
    assert elastic.configured_width() is None and elastic.configured_width(default=3) == 3
    assert not elastic.is_grown_child()
    prev = launcher.set_child_context(launcher.ChildContext(**launcher.context_fields(
        sup._child_env(1, [0, 1, 2, 3], None, grown=True)(2))))
    try:
        assert elastic.configured_width() == 4 and elastic.is_grown_child()
    finally:
        launcher.set_child_context(prev)


def _drive_resize(sup, to_width, reason):
    """Run ``sup`` on a thread; once the gang has made a verified
    checkpoint, ask for the resize from this thread.  Returns the run."""
    result = {}

    def run():
        try:
            result["run"] = sup.run()
        except BaseException as e:
            result["error"] = e
    thread = threading.Thread(target=run)
    thread.start()
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline and sup._latest_checkpoint() is None \
            and thread.is_alive():
        time.sleep(0.02)
    assert sup._latest_checkpoint() is not None, f"no checkpoint: {result.get('error')}"
    sup.request_resize(to_width, reason=reason)
    thread.join(timeout=120.0)
    assert not thread.is_alive(), "supervised run did not finish"
    if "error" in result:
        raise result["error"]
    return result["run"]


@pytest.fixture(scope="module")
def references(spec, tmp_path_factory):
    """The single process's run, and a fixed-width dp2 gang's (started here,
    collected by the first test that reads it, so that it runs meanwhile)."""
    gang = GangHandle(functools.partial(workers.elastic_train_worker,
                                        workdir=str(tmp_path_factory.mktemp("fixed")), spec=spec,
                                        epochs=EPOCHS), 2, FIXED_PORT, timeout=120.0)
    out = {"single": _single(spec)}
    try:
        yield out, gang
    finally:
        gang.shutdown()


def _single(spec):
    from deeplearning4j_tpu_torch.obs.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector
    net = workers.supervised_net(spec, "elastic")
    scores = CollectScoresListener()
    Trainer(net, listeners=[scores]).fit(workers._resumable(0), epochs=EPOCHS)
    return scores.scores, flat_param_vector(net.params_).numpy()


def _held_to_the_references(results, references, width):
    out, gang = references
    if "dp2" not in out:
        out["dp2"] = gang.wait()
    ref_losses, ref_params = out["single"]
    fixed = {r["pid"]: r for r in out["dp2"]}
    assert len(ref_losses) == 6 * EPOCHS
    for r in fixed.values():
        assert r["width"] == 2 and len(r["losses"]) == 6 * EPOCHS
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=0, atol=EXACT)
    for r in results.values():
        assert r["width"] == width
        start = r["end_iteration"] - len(r["losses"])
        # a resumed tail after the boundary, not a replay from scratch
        assert 0 < start and len(r["losses"]) < len(ref_losses)
        np.testing.assert_allclose(r["losses"], fixed[0]["losses"][start:], rtol=0, atol=EXACT)
        np.testing.assert_allclose(r["losses"], ref_losses[start:], rtol=0, atol=EXACT)
        np.testing.assert_allclose(r["params"], fixed[0]["params"], rtol=0, atol=EXACT)
        np.testing.assert_allclose(r["params"], ref_params, rtol=0, atol=EXACT)


def test_supervised_grow_from_one_to_two_matches_the_fixed_width_run(tmp_path, registries,
                                                                     spec, references):
    reg, _ = registries
    server = UIServer(port=0)
    try:
        fn = functools.partial(workers.elastic_train_worker, workdir=str(tmp_path), spec=spec,
                               epochs=EPOCHS, step_delay=0.15)
        sup = ClusterSupervisor(fn, n_processes=1, checkpoint_dir=str(tmp_path),
                                max_restarts=2, min_workers=1, port=GROW_PORT, timeout=120.0,
                                remote_ui=server.url, cluster_store=server.cluster,
                                backoff=NO_WAIT)
        run = _drive_resize(sup, 2, reason="test grow")
        # a planned resize is a round boundary, not an incident
        assert run.incidents == [] and run.slots == [0, 1] and run.generations == 2
        assert sup.width == 2
        results = {r["pid"]: r for r in run.results}
        assert sorted(results) == [0, 1]
        assert all(r["grown"] and r["generation"] == 1 for r in results.values())
        _held_to_the_references(results, references, 2)
        assert reg.counter("tpudl_elastic_grows_total").value == 1
        assert reg.gauge("tpudl_elastic_gang_width").value == 2
        summary = server.cluster.summary()
        assert summary["gang_width"] == 2
        notes = [a for a in summary["annotations"] if a["kind"] == "resize"]
        assert notes and notes[0]["direction"] == "grow" and notes[0]["to_width"] == 2
    finally:
        server.stop()


def test_a_kill_at_gang_grow_recovers_by_respawn(tmp_path, registries, spec, references):
    """The grown slot w1 SIGKILLs itself at ``gang.grow`` (after its
    restore); the supervisor respawns the gang at the grown width from the
    still intact checkpoint, and the run ends at width 2 on the
    references."""
    reg, _ = registries
    fn = functools.partial(workers.elastic_train_worker, workdir=str(tmp_path), spec=spec,
                           epochs=EPOCHS, kill_on_grow=True, step_delay=0.15)
    sup = ClusterSupervisor(fn, n_processes=1, checkpoint_dir=str(tmp_path), max_restarts=2,
                            min_workers=1, port=DRILL_PORT, timeout=120.0, backoff=NO_WAIT)
    run = _drive_resize(sup, 2, reason="test grow under chaos")
    assert len(run.incidents) == 1
    incident = run.incidents[0]
    assert incident.reason == "killed" and incident.restarted and incident.generation == 1
    assert any(slot == 1 and rc is not None and rc < 0 for slot, rc in incident.exits)
    assert run.slots == [0, 1] and sup.width == 2 and run.generations == 3
    results = {r["pid"]: r for r in run.results}
    # the respawn after the kill is not a grow's generation
    assert all(not r["grown"] and r["generation"] == 2 for r in results.values())
    _held_to_the_references(results, references, 2)
    assert reg.counter("tpudl_elastic_grows_total").value == 1
    assert reg.counter("tpudl_resilience_gang_restarts_total").value == 1
