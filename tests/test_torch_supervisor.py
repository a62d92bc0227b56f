"""The port's self-healing gangs (``resilience.supervisor``) held to the
JAX package's (``tests/test_supervisor.py``'s non-slow tests).

- **Kill and heal.** Two workers fit ``tests/cluster_workers.py``'s
  ``_supervised_conf`` net (dropout active, a checkpoint every
  iteration), from the JAX package's initial weights; the supervisor
  gives worker 1 the fault plan ``trainer.step@7:kill`` in generation 0.
  It detects the SIGKILL, tears the gang down, respawns both workers
  from their verified checkpoints, and each worker's losses and params
  are within 1e-6 of the port's own uninterrupted run (the JAX package's
  contract: random streams cannot match across packages).  That
  uninterrupted run, under dropout masks shared with the reference
  (PR 14's way: both packages' draws patched to one mask), is within 1e-6
  of the JAX package's ``run_reference_fit``.  ``ClusterStore`` and
  ``UIServer`` report generation 1 and the restart, as the reference's do.
- **Budget.** A slot that dies in every generation spends
  ``max_restarts=1`` and raises ``GangFailedError`` with the survivors'
  flight dumps attached.
- **Decisions.** ``_apply_budget``'s restart, shrink and halt sequences
  and ``_classify`` equal the reference's; the child-context plumbing
  (worker id, generation, resume pointer, width) carries what the
  reference's environment carries, and a restarted generation gets no
  fault plan.
"""

import functools
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_workers
import torch_cluster_workers as workers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.resilience import faults as jfaults
from deeplearning4j_tpu.resilience.supervisor import ClusterSupervisor as JClusterSupervisor
from deeplearning4j_tpu.resilience.supervisor import GENERATION_ENV, RESUME_ENV
from deeplearning4j_tpu.train.step_cache import clear_step_cache

from deeplearning4j_tpu_torch import resilience
from deeplearning4j_tpu_torch.nn.layers import base
from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, get_registry, set_registry
from deeplearning4j_tpu_torch.obs.ui_server import UIServer
from deeplearning4j_tpu_torch.parallel import launcher
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy
from deeplearning4j_tpu_torch.resilience.supervisor import (ClusterSupervisor, GangFailedError,
                                                            supervise)

HEAL_PORT, BUDGET_PORT = 14311, 14511
EXACT = 1e-6
NO_WAIT = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.array(tree)


@pytest.fixture(scope="module")
def spec():
    """Each worker's net: the reference's configuration and its initial
    weights (``run_reference_fit`` makes the same ones)."""
    out = {}
    for pid in (0, 1):
        conf = cluster_workers._supervised_conf(42 + pid)
        net = JMultiLayerNetwork(conf).init()
        out[pid] = {"conf": conf.to_json(), "p0": _np_tree(net.params_),
                    "s0": _np_tree(net.state_)}
    return out


@pytest.fixture
def registry():
    prev = set_registry(MetricsRegistry())
    yield get_registry()
    set_registry(prev)


@pytest.fixture(autouse=True)
def _no_ambient_fault_plan():
    faults.clear_fault_plan()
    yield
    faults.clear_fault_plan()


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.read().decode()


def test_uninterrupted_run_matches_the_reference_under_shared_masks(spec):
    """The port's uninterrupted run (the heal's yardstick) against the JAX
    package's ``run_reference_fit``, both packages' dropout draws patched
    to one [16, 16] mask."""
    mask = np.random.default_rng(3).random((16, 16)) < 0.8
    draw = base._keep_mask
    base._keep_mask = lambda shape, p, gen, device: torch.as_tensor(mask)
    clear_step_cache()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(mask))
            for pid in (0, 1):
                want_losses, want_params = cluster_workers.run_reference_fit(pid)
                got_losses, got_params = workers.run_reference_fit(spec, pid)
                assert len(got_losses) == len(want_losses) == 12
                np.testing.assert_allclose(got_losses, want_losses, rtol=0, atol=EXACT)
                np.testing.assert_allclose(got_params, want_params, rtol=0, atol=EXACT)
    finally:
        base._keep_mask = draw
        clear_step_cache()


def test_kill_and_heal_matches_the_uninterrupted_run(tmp_path, registry, spec):
    """Worker 1 SIGKILLs itself before step 7 commits (generation 0); the
    supervisor respawns both workers from their verified checkpoints, and
    each completed trajectory (the replayed tail and the final params)
    matches the uninterrupted run to 1e-6, dropout active."""
    refs = {pid: workers.run_reference_fit(spec, pid) for pid in (0, 1)}
    server = UIServer(port=0)
    try:
        fn = functools.partial(workers.supervised_train_worker, workdir=str(tmp_path),
                               spec=spec)
        sup = ClusterSupervisor(fn, n_processes=2, checkpoint_dir=str(tmp_path),
                                max_restarts=2, port=HEAL_PORT, timeout=120.0,
                                remote_ui=server.url, cluster_store=server.cluster,
                                fault_plan={1: "trainer.step@7:kill"}, backoff=NO_WAIT)
        run = sup.run()

        # one recovery, for the killed slot
        assert run.recovered and len(run.incidents) == 1
        incident = run.incidents[0]
        assert incident.reason == "killed"
        assert any(slot == 1 and rc is not None and rc < 0 for slot, rc in incident.exits)
        assert incident.restarted and incident.resumed_from is None   # generation 0 began afresh
        assert incident.mttr_s is not None and incident.mttr_s > 0
        assert incident.steps_replayed is not None and incident.steps_replayed >= 0
        assert run.generations == 2 and run.slots == [0, 1]

        # the 1e-6 contract, per worker
        results = {r["pid"]: r for r in run.results}
        assert sorted(results) == [0, 1]
        for pid in (0, 1):
            losses_ref, params_ref = refs[pid]
            r = results[pid]
            assert r["generation"] == 1 and r["worker"] == f"w{pid}"
            start = r["end_iteration"] - len(r["losses"])
            np.testing.assert_allclose(r["losses"], losses_ref[start:], rtol=0, atol=EXACT)
            np.testing.assert_allclose(r["params"], params_ref, rtol=0, atol=EXACT)
        # the killed worker replayed its tail from its resume point
        assert 0 < len(results[1]["losses"]) < len(refs[1][0])

        # generation-aware federation
        summary = json.loads(_get(server.url + "cluster.json"))
        for w in ("w0", "w1"):
            assert summary["workers"][w]["generation"] == 1
            assert summary["workers"][w]["restarts"] == 1
        assert summary["restarts"] and {r["to_generation"] for r in summary["restarts"]} == {1}
        assert summary["gang_width"] == 2
        html = _get(server.url + "cluster")
        assert "generation" in html and "Restarts" in html
        body = _get(server.url + "metrics")
        assert 'tpudl_cluster_worker_generation{worker="w1"} 1' in body
        assert registry.counter("tpudl_resilience_gang_restarts_total").value == 1
        assert registry.histogram("tpudl_resilience_gang_mttr_seconds").count == 1
    finally:
        server.stop()


def test_restart_budget_exhaustion_raises_with_flight_dumps(registry, spec):
    """Slot 1 dies in EVERY generation; with max_restarts=1 the second
    death spends the budget and GangFailedError carries both incidents
    and the survivors' black boxes."""
    fn = functools.partial(workers.repeatedly_dying_worker, spec=spec, die_pid=1, kill_at=2)
    sup = ClusterSupervisor(fn, n_processes=2, max_restarts=1, port=BUDGET_PORT,
                            timeout=120.0, backoff=NO_WAIT)
    with pytest.raises(GangFailedError) as exc_info:
        sup.run()
    err = exc_info.value
    assert len(err.incidents) == 2
    assert all(i.reason == "killed" for i in err.incidents)
    assert err.incidents[0].restarted and not err.incidents[1].restarted
    assert "max_restarts=1" in str(err)
    assert err.flight_dumps, "no flight dumps attached to the failure"
    headers = [line for dump in err.flight_dumps.values() for line in dump
               if line.get("type") == "header"]
    assert headers and all(k.startswith("g") for k in err.flight_dumps)
    assert registry.counter("tpudl_resilience_gang_restarts_total").value == 1


@pytest.mark.parametrize("policy,n,max_restarts,min_workers,calls", [
    ("shrink", 3, 1, 1, [([1], [0, 1, 2]), ([1], [0, 1, 2]), ([0], [0, 2]), ([0], [0, 2])]),
    ("shrink", 2, 0, 2, [([1], [0, 1])]),
    ("halt", 2, 1, 1, [([0], [0, 1]), ([0], [0, 1])]),
    ("shrink", 4, 2, 2, [([0, 3], [0, 1, 2, 3])] * 3 + [([1], [1, 2]), ([1], [1, 2])]),
])
def test_budget_decisions_equal_the_reference(policy, n, max_restarts, min_workers, calls):
    kw = {"n_processes": n, "max_restarts": max_restarts, "degradation": policy,
          "min_workers": min_workers}
    port = ClusterSupervisor(workers.trivial_worker, **kw)
    ref = JClusterSupervisor(cluster_workers.trivial_worker, **kw)
    got_restarts, want_restarts = {}, {}
    for failed, slots in calls:
        got = port._apply_budget(failed, slots, got_restarts)
        want = ref._apply_budget(failed, slots, want_restarts)
        assert got == want, (failed, slots)
        assert got_restarts == want_restarts
    with pytest.raises(ValueError, match="degradation"):
        ClusterSupervisor(workers.trivial_worker, degradation="explode")


@pytest.mark.parametrize("failed", [[(1, -9)], [(0, 87)], [(0, 1)], [(0, 1), (1, 87)],
                                    [(0, 1), (1, -15)], [(2, None)]])
def test_classify_equals_the_reference(failed):
    assert ClusterSupervisor._classify(failed) == JClusterSupervisor._classify(failed)


def test_child_context_plumbing_follows_the_reference(tmp_path, spec):
    """A respawned child gets its stable slot identity, the generation, the
    width, the resume pointer (only when a verified checkpoint exists) and
    no fault plan, as the reference's environment carries them."""
    port = ClusterSupervisor(workers.trivial_worker, n_processes=2,
                             checkpoint_dir=str(tmp_path), fault_plan={1: "trainer.step@7:kill"})
    ref = JClusterSupervisor(cluster_workers.trivial_worker, n_processes=2,
                             checkpoint_dir=str(tmp_path))

    def both(generation, slots, resume, pid):
        ctx = launcher.context_fields(port._child_env(generation, slots, resume)(pid))
        env = ref._child_env(generation, slots, resume)(pid)
        assert ctx["worker"] == env["DL4J_TPU_WORKER_ID"]
        assert str(ctx["generation"]) == env[GENERATION_ENV]
        assert ctx.get("resume_from") == env.get(RESUME_ENV)
        assert str(ctx["gang_width"]) == env["DL4J_TPU_GANG_WIDTH"]
        return ctx, env

    assert port._latest_checkpoint() is None is ref._latest_checkpoint()
    ctx, env = both(0, [0, 1], None, 1)
    assert ctx["worker"] == "w1" and ctx["fault_plan"] == "trainer.step@7:kill"
    assert "resume_from" not in ctx and jfaults.ENV_VAR not in env
    assert "fault_plan" not in both(0, [0, 1], None, 0)[0]
    # a verified checkpoint appears (a per-worker subdirectory), made by the port
    net = workers.supervised_net(spec, 1)
    net.save(str(tmp_path / "w0" / "checkpoint_iter3_epoch0.zip"))
    found = port._latest_checkpoint()
    assert found and found.endswith("checkpoint_iter3_epoch0.zip")
    assert ref._latest_checkpoint() == found
    ctx, env = both(1, [0, 1], found, 1)
    assert ctx["resume_from"] == str(tmp_path) and ctx["generation"] == 1
    assert "fault_plan" not in ctx and env[jfaults.ENV_VAR] == ""   # the drill fires once
    ctx, _ = both(2, [2], found, 0)           # after a shrink, process 0 owns slot 2
    assert ctx["worker"] == "w2" and ctx["gang_width"] == 1
    # unknown context fields are refused; the launcher's default context is empty
    with pytest.raises(ValueError, match="unknown child context"):
        launcher.context_fields({"rank": 1})
    assert launcher.child_context() == launcher.ChildContext()
    prev = launcher.set_child_context(launcher.ChildContext(worker="w5", resume_from="x"))
    try:
        assert launcher.child_context().worker == "w5"
    finally:
        launcher.set_child_context(prev)


def test_supervisor_surface_and_artifact_bake_refusal():
    for name in ("ClusterSupervisor", "GangFailedError", "GangIncident", "SupervisedRun",
                 "supervise"):
        assert name in resilience.__all__
    with pytest.raises(NotImplementedError, match="artifact_store"):
        ClusterSupervisor(workers.trivial_worker, artifact_bake=True)
    assert ClusterSupervisor(workers.trivial_worker, artifact_bake=None).width == 2
    assert callable(supervise)
