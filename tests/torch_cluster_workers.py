"""Workers that the port's multi-process tests run in child processes of
``deeplearning4j_tpu_torch.parallel.launcher.spawn_local_cluster``
(module-level, so that they pickle by name; they import nothing of JAX)."""

import functools

import numpy as np

STEPS, GLOBAL_BATCH, TAU0 = 4, 16, 2e-2


def dense_net():
    """``tests/test_dcn.py``'s Dense(16, tanh) + softmax(3) net on 8
    features, initialised by the port from its seed (the same values in
    every process)."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train import Sgd
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1)).weight_init("xavier")
            .list().layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def global_batches():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(STEPS * GLOBAL_BATCH, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, STEPS * GLOBAL_BATCH)]
    return [(x[i:i + GLOBAL_BATCH], y[i:i + GLOBAL_BATCH])
            for i in range(0, STEPS * GLOBAL_BATCH, GLOBAL_BATCH)]


def algorithm():
    from deeplearning4j_tpu_torch.parallel import AdaptiveThresholdAlgorithm
    return AdaptiveThresholdAlgorithm(initial_threshold=TAU0)


def dcn_fit_worker(pid, n, ring_port):
    """One slice leader: MultiSliceTrainer(world_size=n) over a ring
    SocketTransport, the device codec and the overlapped exchange, on rows
    ``pid::n`` of each global batch; returns its params, losses and
    whether every rank holds the same params (a gloo all-gather)."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel import MultiSliceTrainer, SocketTransport
    from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector
    net = dense_net()
    transport = SocketTransport(pid, n, port=ring_port, timeout=60.0)
    trainer = MultiSliceTrainer(net, n_slices=1, world_size=n, rank_offset=pid,
                                transports=[transport], overlap=True, devices=["cpu"],
                                algorithm=algorithm())
    try:
        losses = [trainer.fit_batch(DataSet(x[pid::n], y[pid::n]))
                  for x, y in global_batches()]
        trainer.collect()
    finally:
        trainer.close()
        transport.close()
    flat = flat_param_vector(net.params_)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat)
    return {"pid": pid, "world": dist.get_world_size(), "losses": losses,
            "params": flat.numpy(), "all_equal": all(torch.equal(p, flat) for p in parts),
            "bytes_sent": transport.bytes_sent}


def failing_worker(pid, n):
    """Rank 1 raises; rank 0 returns."""
    if pid == 1:
        raise ValueError("planted failure in rank 1")
    return {"pid": pid}


# ------------------------------------------------------ data parallelism
# tests/test_torch_data_parallel.py's rank: every case of the port's dense
# layouts, from the JAX package's initial weights (``spec``: numpy trees,
# confs as JSON, data), each rank's results as numpy.

def _np(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def _dp_net(case):
    from deeplearning4j_tpu_torch.interop import load_jax_params
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if case["graph"]:
        net = ComputationGraph(ComputationGraphConfiguration.from_json(case["conf"]),
                               device="cpu")
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(case["conf"]), device="cpu")
    return load_jax_params(net, case["p0"], case["s0"])


def _dp_iterator(case):
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator, ResumableIterator
    b, x, y = case["batch"], case["x"], case["y"]
    fm, lm = case.get("fmask"), case.get("lmask")
    return ResumableIterator(ListDataSetIterator([
        DataSet(x[i:i + b], y[i:i + b], None if fm is None else fm[i:i + b],
                None if lm is None else lm[i:i + b]) for i in range(0, len(x), b)]))


class _Scores:
    def __init__(self):
        self.losses = []

    def iteration_done(self, net, iteration, epoch, score):
        self.losses.append(float(score))


def _dp_fit(case, trainer_fn, listeners=(), resume_from=None):
    """Fit ``case``'s net through ``trainer_fn(net, listeners)``; the
    losses reported, the trees after, and the trainer."""
    net = _dp_net(case)
    scores = _Scores()
    trainer = trainer_fn(net, [scores, *listeners])
    trainer.fit(_dp_iterator(case), epochs=case["epochs"], resume_from=resume_from)
    return {"losses": scores.losses, "params": _np(net.params_), "state": _np(net.state_),
            "equal_ranks": _all_equal([net.params_, net.state_])}, trainer


def _all_equal(tree) -> bool:
    """Whether every rank holds the same bytes of ``tree`` (its flat vector
    gathered over the default group)."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector
    flat = flat_param_vector(tree).detach().cpu().to(torch.float64)
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return all(torch.equal(p, flat) for p in parts)


def data_parallel_worker(pid, n, spec_path, wait_s=120.0):
    """Waits for the pickled ``spec`` at ``spec_path`` (the parent writes
    it once the JAX package has made the weights, so that the ranks start
    meanwhile), then runs every case."""
    import os
    import pickle
    import time
    import warnings
    deadline = time.monotonic() + wait_s
    while not os.path.exists(spec_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no spec at {spec_path} after {wait_s} s")
        time.sleep(0.05)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.nn.layers import base
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    from deeplearning4j_tpu_torch.parallel import make_mesh, mesh
    from deeplearning4j_tpu_torch.train import Trainer
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    def dp2(net, listeners):
        return Trainer(net, listeners, layout="dp2")

    out = {}
    # the dropout MLP: the shared masks of the reference's run, then the
    # port's own stream against the port's single-process run
    case = spec["dropout"]
    draw = base._keep_mask
    base._keep_mask = lambda shape, p, gen, device: torch.as_tensor(case["masks"][tuple(shape)])
    try:
        out["dropout_shared"], tr = _dp_fit(case, dp2)
    finally:
        base._keep_mask = draw
    out["dropout_own"], _ = _dp_fit(case, dp2)
    out["dropout_single"], _ = _dp_fit(case, lambda net, ls: Trainer(net, ls))
    out["step_key"] = tr._step_key("train")
    out["single_key"] = Trainer(_dp_net(case))._step_key("train")
    out["eager_reason"] = tr._step.eager_reason
    out["signature"] = tr._layout.cache_signature()
    reg = get_registry()
    out["gauges"] = {"devices": reg.gauge("tpudl_mesh_devices").value,
                     "axes": {a: reg.labeled_gauge("tpudl_mesh_axis_size", label_names=("axis",))
                              .labeled_value(axis=a) for a in mesh.MESH_AXES},
                     "active": reg.labeled_gauge("tpudl_mesh_layout_active",
                                                 label_names=("layout",))
                     .labeled_value(layout="dp2"),
                     "bytes": reg.gauge("tpudl_mesh_collective_bytes").value,
                     "parallel_devices": reg.gauge("tpudl_parallel_mesh_devices").value}
    layout = mesh.resolve_layout(layout="dp2", devices="cpu")
    out["collective_bytes"] = [layout.collective_bytes_per_step(b) for b in spec["param_bytes"]]
    out["layout_errors"] = {}
    for bad in ("dp4", "dp2xtp2"):
        try:
            mesh.resolve_layout(layout=bad, devices="cpu")
        except (ValueError, NotImplementedError) as e:
            out["layout_errors"][bad] = (type(e).__name__, str(e))
    out["mesh_shape"] = make_mesh(devices="cpu").shape

    # the fused graph through the plain matmul_bn_act; dense + BN with a
    # checkpoint every other iteration (rank 0 writes), then its resume
    out["fused"], _ = _dp_fit(spec["fused"], dp2)
    case = spec["dense_bn"]
    ckpt = os.path.join(spec["workdir"], "ckpt")
    listener = CheckpointListener(ckpt, save_every_n_iterations=2)
    out["dense_bn"], _ = _dp_fit(case, dp2, listeners=[listener])
    out["saved"] = list(listener._saved)
    dist.barrier()
    out["listed"] = sorted(f for f in os.listdir(ckpt) if f.endswith(".zip"))
    out["resumed"], _ = _dp_fit(case, dp2, resume_from=ckpt)
    # the masked recurrent net, its shards' mask counts unequal, with l2
    out["masked_rnn"], _ = _dp_fit(spec["masked_rnn"], dp2)
    out["tbptt_rnn"], _ = _dp_fit(spec["tbptt_rnn"], dp2)

    # ParallelWrapper: the averaging mode with and without the updater
    # state, each step's trees byte-equal across the ranks or not
    case = spec["averaging"]
    for avg_state in (True, False):
        equal = []

        class Watch:
            def iteration_done(self, net, iteration, epoch, score):
                equal.append((_all_equal(net.params_), _all_equal(net.opt_state)))

        res, _ = _dp_fit(case, lambda net, ls: ParallelWrapper(
            net, mesh=make_mesh(devices="cpu"), listeners=ls, averaging_frequency=2,
            average_updater_state=avg_state), listeners=[Watch()])
        res["equal_after_step"] = equal
        out[f"averaging_{avg_state}"] = res
    # ZeRO-1 against the unsharded run
    case = spec["zero"]
    res, pw = _dp_fit(case, lambda net, ls: ParallelWrapper(
        net, mesh=make_mesh(devices="cpu"), listeners=ls, zero_optimizer_sharding=True))
    res["opt_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(pw.net.opt_state))
    res["owners"] = pw.tx.owners
    out["zero"] = res
    res, tr = _dp_fit(case, dp2)
    res["opt_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(tr.net.opt_state))
    out["unsharded"] = res
    out["stats"] = {k: (s.calls, s.bytes) for k, s in tr._layout.stats.items()}
    return out


# ------------------------------------------------------ multi-slice gangs
# tests/test_torch_multislice.py's rank: MultiSliceTrainer(n_slices=2,
# data_per_slice=2) in a gang of 4, from the JAX package's weights.

def _wait_for_spec(spec_path, wait_s=120.0):
    import os
    import pickle
    import time
    deadline = time.monotonic() + wait_s
    while not os.path.exists(spec_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no spec at {spec_path} after {wait_s} s")
        time.sleep(0.05)
    with open(spec_path, "rb") as f:
        return pickle.load(f)


def _slice_digests(*trees):
    """Every rank's sha256 of ``trees`` (an all-gather of digests)."""
    import hashlib
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(list(trees)):
        if torch.is_tensor(t):
            h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, h.hexdigest())
    return out


def _multislice_case(case, mesh, steps, **kw):
    """``steps`` steps of ``case``'s net under MultiSliceTrainer(2, 2): the
    slice's losses, the divergence and every rank's digest after each step,
    the wire stats and compact messages of each step, and the trees after."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel import AdaptiveThresholdAlgorithm, MultiSliceTrainer
    from deeplearning4j_tpu_torch.parallel import dcn_trainer
    from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector
    net = _dp_net(case)
    sent = []
    compact = dcn_trainer.compact_device_message

    def recording(msg, capacity):
        out = compact(msg, capacity)
        sent.append(np.array(out))
        return out

    dcn_trainer.compact_device_message = recording
    tr = MultiSliceTrainer(net, 2, algorithm=AdaptiveThresholdAlgorithm(
        initial_threshold=case["tau"]), mesh=mesh, **kw)
    out = {"losses": [], "divergence": [], "digests": [], "wire": []}

    def watch():
        out["divergence"].append(tr.max_param_divergence())
        out["digests"].append(_slice_digests(tr.slice_params[0], tr.slice_state[0],
                                             tr.slice_opt[0]))

    try:
        batch = DataSet(case["x"], case["y"])
        for _ in range(steps):
            out["losses"].append(tr.fit_batch(batch))
            watch()
            out["wire"].append([dict(w) for w in tr.last_wire_stats])
        tr.finish()      # overlap: the last exchange lands
        watch()
        state = tr.codec_state()[0]
    finally:
        dcn_trainer.compact_device_message = compact
        tr.close()
    kind = "dcn_grad_encode" if kw.get("device_encode", True) else "dcn_grad"
    out.update(messages=sent, params=flat_param_vector(tr.slice_params[0]).numpy(),
               state=_np(tr.slice_state[0]), residual=np.asarray(state["residual"]),
               threshold=state["threshold"], capacity=tr.capacity, slice=tr.rank_offset,
               world=tr.world_size, stats={k: (c.calls, c.bytes)
                                           for k, c in tr._layout.stats.items()},
               eager=tr._steps[kind].get(0).eager_reason)
    return out


def multislice_worker(pid, n, spec_path):
    """One rank of the 4-rank gang: the mesh cases, then each trainer case
    of ``spec`` (written by the parent once the JAX package has made the
    weights)."""
    spec = _wait_for_spec(spec_path)
    from deeplearning4j_tpu_torch.parallel import make_multislice_mesh
    out = {"pid": pid}
    meshes = {}
    for shape in ((2, 2), (4, 1), (1, 4)):
        m = make_multislice_mesh(*shape, devices="cpu")
        meshes[shape] = m
        out[f"mesh_{shape}"] = {"axes": m.axis_names, "shape": m.shape,
                                "position": m.position(), "leader": m.is_leader,
                                "slice_ranks": m.slice_ranks(m.slice_index),
                                "layout": m.layout().describe()}
    out["errors"] = {}
    for args in ((2, 4), (2, 2, 2), (1, 2)):
        try:
            make_multislice_mesh(*args, devices="cpu")
        except (ValueError, NotImplementedError) as e:
            out["errors"][args] = (type(e).__name__, str(e))
    mesh = meshes[(2, 2)]
    steps = spec["steps"]
    out["device"] = _multislice_case(spec["dense"], mesh, steps)
    out["host"] = _multislice_case(spec["dense"], None, steps, data_per_slice=2,
                                   device_encode=False, devices="cpu")
    out["overlap"] = _multislice_case(spec["dense"], mesh, steps, overlap=True)
    out["layout"] = _multislice_case(spec["dense"], None, 2, layout="dp2", devices="cpu")
    out["fused"] = _multislice_case(spec["fused"], mesh, spec["fused_steps"])
    return out


# ----------------------------------------------------- supervised gangs
# tests/test_torch_supervisor.py's and tests/test_torch_elastic.py's
# workers: the port's counterparts of tests/cluster_workers.py's
# _supervised_conf, supervised_batches, run_reference_fit and
# supervised_train_worker.  ``spec`` carries each net's configuration (the
# JAX package's, as JSON) and its initial weights (``interop.load_jax_params``).

def supervised_batches(pid, n_batches=6, batch=16):
    """tests/cluster_workers.py's supervised_batches, as the port's DataSets."""
    from deeplearning4j_tpu_torch.data import DataSet
    rng = np.random.default_rng(11 + pid)
    x = rng.normal(size=(n_batches * batch, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n_batches * batch)]
    return [DataSet(x[i:i + batch], y[i:i + batch]) for i in range(0, n_batches * batch, batch)]


def supervised_net(spec, key):
    """The port's net ``spec[key]`` (conf JSON and the JAX package's
    initial weights), on the CPU."""
    from deeplearning4j_tpu_torch.interop import load_jax_params
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    case = spec[key]
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(case["conf"]), device="cpu")
    return load_jax_params(net, case["p0"], case["s0"])


def _resumable(pid):
    from deeplearning4j_tpu_torch.data import ListDataSetIterator, ResumableIterator
    return ResumableIterator(ListDataSetIterator(supervised_batches(pid)))


class _Sleep:
    """Slows a fit down (a sleep after each step), so that a test can act
    while it runs."""

    def __init__(self, seconds):
        self.seconds = seconds

    def iteration_done(self, net, iteration, epoch, score):
        import time
        time.sleep(self.seconds)


def run_reference_fit(spec, pid, epochs=2):
    """The uninterrupted single-process run that the supervised gang must
    match to 1e-6: the same net, data and seed as
    :func:`supervised_train_worker`."""
    from deeplearning4j_tpu_torch.obs.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.train import Trainer
    from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector
    net = supervised_net(spec, pid)
    scores = CollectScoresListener()
    Trainer(net, listeners=[scores]).fit(_resumable(pid), epochs=epochs)
    return scores.scores, flat_param_vector(net.params_).numpy()


def supervised_train_worker(pid, n, workdir=None, spec=None, epochs=2):
    """The kill-and-heal worker: a fit (dropout active) with a checkpoint
    every iteration into ``workdir/w<pid>``; a respawned worker resumes
    from its own newest verified checkpoint when its launcher context says
    there is one.  The supervisor hands the fault plan (generation 0 only).
    Returns the losses it ran, the iteration it ended at and its params."""
    import os
    from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.obs.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.parallel.launcher import child_context
    from deeplearning4j_tpu_torch.train import Trainer
    from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector
    ctx = child_context()
    net = supervised_net(spec, pid)
    iterator = _resumable(pid)
    ckpt_dir = os.path.join(workdir, f"w{pid}")
    ckpt = CheckpointListener(ckpt_dir, save_every_n_iterations=1, keep_last=3,
                              iterator=iterator)
    scores = CollectScoresListener()
    Trainer(net, listeners=[scores, ckpt]).fit(
        iterator, epochs=epochs, resume_from=ckpt_dir if ctx.resume_from else None)
    return {"pid": pid, "generation": ctx.generation, "worker": ctx.worker,
            "losses": list(scores.scores), "end_iteration": net.iteration,
            "params": flat_param_vector(net.params_).numpy()}


def repeatedly_dying_worker(pid, n, spec=None, die_pid=None, kill_at=2, steps=60):
    """Budget exhaustion: ``die_pid`` SIGKILLs itself in EVERY generation
    (its plan installed here, which the supervisor cannot clear); the
    others train slowly, so that the teardown finds them mid-fit and their
    flight recorders write the black boxes that the error carries."""
    import time
    import torch
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.train import Trainer
    if pid == die_pid:
        faults.install_fault_plan(faults.FaultPlan.parse(f"trainer.step@{kill_at}:kill"))
    net = supervised_net(spec, pid)
    batch = supervised_batches(pid)[0]
    trainer = Trainer(net)
    gen = torch.Generator().manual_seed(pid)
    for _ in range(steps):
        trainer.step_batch(batch, gen)
        time.sleep(0.1)      # alive until the supervisor's teardown
    return {"pid": pid, "steps": steps}


def trivial_worker(pid, n):
    return {"pid": pid}


def elastic_train_worker(pid, n, workdir=None, spec=None, epochs=4, kill_on_grow=False,
                         step_delay=0.0):
    """The elastic gang's worker: one fit (dropout active) under
    ``Trainer(layout="dp<width>")``, the width from the launcher context
    (``elastic.configured_width``), never hard-coded; every worker runs the
    same trajectory, and slot w0 checkpoints every iteration into a SHARED
    directory, so that a gang relaunched at a new width resumes from its
    newest verified checkpoint.  ``kill_on_grow``: in a grow's generation,
    slot w1 installs ``gang.grow@0:kill`` (``Trainer.resume_state`` fires
    that site after the restore).  ``step_delay``: seconds to sleep after
    each step of generation 0."""
    import os
    from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.obs.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.parallel.launcher import child_context
    from deeplearning4j_tpu_torch.resilience import elastic, faults
    from deeplearning4j_tpu_torch.train import Trainer
    from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector
    ctx = child_context()
    width = elastic.configured_width(default=n)
    slot = ctx.worker or f"w{pid}"
    if kill_on_grow and elastic.is_grown_child() and slot == "w1":
        faults.install_fault_plan(faults.FaultPlan.parse("gang.grow@0:kill"))
    net = supervised_net(spec, "elastic")
    iterator = _resumable(0)
    scores = CollectScoresListener()
    listeners = [scores]
    ckpt_dir = os.path.join(workdir, "shared")
    if slot == "w0":
        listeners.append(CheckpointListener(ckpt_dir, save_every_n_iterations=1, keep_last=3,
                                            iterator=iterator))
    if step_delay and ctx.generation == 0:
        listeners.append(_Sleep(step_delay))
    Trainer(net, listeners, layout=f"dp{width}").fit(
        iterator, epochs=epochs, resume_from=ckpt_dir if ctx.resume_from else None)
    return {"pid": pid, "slot": slot, "width": width, "generation": ctx.generation,
            "grown": elastic.is_grown_child(), "losses": list(scores.scores),
            "end_iteration": net.iteration, "params": flat_param_vector(net.params_).numpy()}


def telemetry_train_worker(pid, n, steps=6, straggler_pid=None, delay_s=0.25):
    """A few steps of the dense net with the launcher's telemetry router
    installed by the child's bootstrap; ``straggler_pid`` sleeps
    ``delay_s`` inside each step (a ``trainer.step`` delay rule)."""
    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.obs import remote
    from deeplearning4j_tpu_torch.parallel.launcher import child_context
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.train import Trainer
    if pid == straggler_pid:
        faults.install_fault_plan(faults.FaultPlan.parse(
            f"trainer.step@0:delay:{delay_s}:{steps}"))
    trainer = Trainer(dense_net())
    x, y = global_batches()[0]
    gen = torch.Generator().manual_seed(pid)
    for _ in range(steps):
        trainer.step_batch(DataSet(x, y), gen)
    return {"pid": pid, "worker": child_context().worker,
            "router": remote.get_router() is not None}


def mesh_worker(pid, n, shapes):
    """Each multi-slice mesh of ``shapes`` over the gang: this rank's
    position, and the sums over its slice's groups and the leaders' group
    of every rank's id (which show who is in each)."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import make_multislice_mesh
    out = {"pid": pid}
    for shape in shapes:
        m = make_multislice_mesh(*shape, devices="cpu")
        mine = torch.tensor([float(pid)])
        sums = {}
        for name, group in (("slice", m.group), ("relay", m.relay_group)):
            t = mine.clone()
            dist.all_reduce(t, group=group)
            sums[name] = t.item()
        if m.is_leader:
            t = mine.clone()
            dist.all_reduce(t, group=m.leader_group)
            sums["leaders"] = t.item()
        box = [pid]
        dist.broadcast_object_list(box, src=m.leader(), group=m.relay_group)
        sums["relayed_from"] = box[0]
        out[shape] = {"position": m.position(), "leader": m.is_leader, "sums": sums,
                      "layout": m.layout().describe(), "shape": m.shape}
    return out


# ------------------------------------------------- in-process resize (gangs of 4)
# tests/test_torch_elastic_inprocess.py's rank: Trainer(layout="dp<w>") in a
# gang of 4 that grows and shrinks inside one fit, from the JAX package's
# weights.

def _elastic_fit(spec, start, resize_to=None, boundary=2, epochs=4, masks=None):
    """tests/test_elastic.py's _elastic_run: one fit of the dropout MLP under
    ``start``, ``request_resize(resize_to)`` at the end of epoch
    ``boundary`` - 1; with ``masks`` every dropout draw is the given mask of
    its shape.  Returns (losses, flat params, trainer)."""
    import torch
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.layers import base
    from deeplearning4j_tpu_torch.train import Trainer
    from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector
    net = supervised_net(spec, "mlp")
    trainer = Trainer(net, layout=start)
    losses = []

    class Rec:
        def iteration_done(self, net, iteration, epoch, score):
            losses.append(float(score))

        def on_epoch_end(self, net, epoch, info):
            if resize_to is not None and epoch + 1 == boundary:
                trainer.request_resize(resize_to)

    trainer.bus.listeners.append(Rec())
    x, y = spec["x"], spec["y"]
    it = ListDataSetIterator([DataSet(x[i:i + 16], y[i:i + 16]) for i in range(0, len(x), 16)])
    draw = base._keep_mask
    if masks is not None:
        base._keep_mask = lambda shape, p, gen, device: torch.as_tensor(masks[tuple(shape)])
    try:
        trainer.fit(it, epochs=epochs)
    finally:
        base._keep_mask = draw
    return losses, flat_param_vector(net.params_).detach().numpy(), trainer


def inprocess_elastic_worker(pid, n, spec_path):
    """Every run of tests/test_torch_elastic_inprocess.py in one rank: the
    fixed dp4 and dp2 runs, the grow dp2 -> dp4 and the shrink dp4 -> dp2
    inside one fit (the port's own dropout stream, then the reference's
    masks), the crash at ``gang.grow``, and the refusals."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.obs import flight_recorder
    from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, set_registry
    from deeplearning4j_tpu_torch.parallel.mesh import LayoutResizeError
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.train import Trainer
    spec = _wait_for_spec(spec_path)
    out = {"pid": pid}

    def series(reg):
        return {"grows": reg.counter("tpudl_elastic_grows_total").value,
                "shrinks": reg.counter("tpudl_elastic_shrinks_total").value,
                "width": reg.gauge("tpudl_elastic_gang_width").value,
                "flips": reg.histogram("tpudl_elastic_flip_seconds").count}

    for name, start, to in (("fixed4", "dp4", None), ("grow", "dp2", 4), ("fixed2", "dp2", None),
                            ("shrink", "dp4", 2)):
        for masks in (None, spec["masks"]):
            reg = MetricsRegistry()
            set_registry(reg)
            losses, params, tr = _elastic_fit(spec, start, to, masks=masks)
            key = name if masks is None else f"{name}_shared"
            events = [e for e in flight_recorder.get_recorder().events()
                      if e.get("kind") == "elastic_resize"]
            out[key] = {"losses": losses, "params": params, "width": tr._layout.spec.total(),
                        "parked": tr.parked, "equal": _all_equal(tr.net.params_),
                        "series": series(reg),
                        "event": {k: events[-1].get(k) for k in
                                  ("direction", "from_width", "to_width", "layout")}
                        if events else None}

    # the crash at gang.grow: every rank stays on dp2, trainable, no deadlock
    reg = MetricsRegistry()
    set_registry(reg)
    x, y = spec["x"], spec["y"]
    batches = [DataSet(x[i:i + 16], y[i:i + 16]) for i in range(0, len(x), 16)]
    trainer = Trainer(supervised_net(spec, "mlp"), layout="dp2")
    trainer.fit(batches, epochs=1)
    crash = {}
    with faults.inject("gang.grow@0:crash"):
        try:
            trainer.resize_mesh(4)
        except faults.InjectedCrash as e:
            crash["raised"] = type(e).__name__
    crash["width_after"] = trainer._layout.spec.total()
    crash["placed"] = trainer._layout_placed
    crash["parked"] = trainer.parked
    trainer.fit(batches, epochs=1)
    crash["width_after_fit"] = trainer._layout.spec.total()
    crash["landed"] = trainer.resize_mesh(4)
    crash["width_final"] = trainer._layout.spec.total()
    crash["equal"] = _all_equal(trainer.net.params_)
    crash["series"] = series(reg)
    out["crash"] = crash
    refusals = {}
    for width in (8, 0):
        try:
            trainer.request_resize(width)
        except LayoutResizeError as e:
            refusals[width] = str(e)
    try:
        Trainer(supervised_net(spec, "mlp")).request_resize(2)
    except ValueError as e:
        refusals["no_layout"] = str(e)
    out["refusals"] = refusals
    return out


# ------------------------------------------------- the arbiter under live serving
# tests/test_torch_arbiter.py's rank: a dp4 gang; rank 0 also hosts the
# serving router, the clients and the arbiter (tests/test_elastic.py's
# test_borrow_return_under_live_serve_load).

def arbiter_live_worker(pid, n, spec_path):
    import os
    import threading
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, set_registry
    from deeplearning4j_tpu_torch.resilience import DevicePoolArbiter, TrainerGang
    from deeplearning4j_tpu_torch.serve import ModelRegistry, ReplicaRouter
    from deeplearning4j_tpu_torch.train import Trainer
    spec = _wait_for_spec(spec_path)
    reg = MetricsRegistry()
    set_registry(reg)
    x, y = spec["x"], spec["y"]
    batches = [DataSet(x[i:i + 16], y[i:i + 16]) for i in range(0, len(x), 16)]
    trainer = Trainer(supervised_net(spec, "train"), layout="dp4")
    trainer.fit(batches, epochs=1)
    out = {"pid": pid, "widths": [trainer._layout.spec.total()]}
    if pid != 0:
        for _ in range(2):
            trainer.fit(batches, epochs=1)
            out["widths"].append(trainer._layout.spec.total())
            out.setdefault("parked", []).append(trainer.parked)
        return out
    snet = supervised_net(spec, "serve")
    path = os.path.join(os.path.dirname(spec_path), "serve.zip")
    snet.save(path)
    models = ModelRegistry(device="cpu", max_batch=8, max_latency_ms=2, queue_limit=64)
    models.deploy("m", path)
    router = ReplicaRouter(models, "m", replicas=2, max_replicas=4)
    arb = DevicePoolArbiter(router, TrainerGang(trainer), min_train=2, chips_per_flip=2,
                            cooldown_s=0.0, serve_chips=2)
    xs = x[:8]
    expected = snet.output(xs).numpy()
    stop, errors, served = threading.Event(), [], [0]

    def client():
        while not stop.is_set():
            try:
                got, _ = models.predict_versioned("m", xs, timeout_s=30)
                np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)
                served[0] += 1
            except Exception as e:  # noqa: BLE001 — the assertion
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        out["borrowed"] = arb.borrow()
        out["replicas_after_borrow"] = (router.replicas, router.max_replicas)
        out["gang_width_after_borrow"] = arb.gang.width
        trainer.fit(batches, epochs=1)            # the shrink lands at the boundary
        out["widths"].append(trainer._layout.spec.total())
        out["returned"] = arb.return_chips()
        trainer.fit(batches, epochs=1)            # and the grow back
        out["widths"].append(trainer._layout.spec.total())
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    replicas = (router.replicas, router.max_replicas)
    models.close()
    out.update(errors=errors, served=served[0], snapshot=arb.snapshot(), replicas=replicas,
               series={"borrows": reg.counter("tpudl_elastic_borrows_total").value,
                       "returns": reg.counter("tpudl_elastic_returns_total").value,
                       "flips": reg.histogram("tpudl_elastic_flip_seconds").count,
                       "pool": {o: reg.labeled_gauge("tpudl_elastic_pool_devices",
                                                     label_names=("owner",)).labeled_value(owner=o)
                                for o in ("serve", "train")}})
    return out


# ------------------------------------------------ sequence-parallel attention
# tests/test_torch_sequence_parallel.py's rank: ring and Ulysses attention on
# this rank's shard of the global arrays, over a seq-4 mesh and a dp2 x sp2
# mesh of the gang of 4.

def _shard(mesh, x, data: int, seq: int):
    """This rank's [B/data, T/seq, ...] of the global numpy array ``x``."""
    import torch
    b, t = x.shape[0] // data, x.shape[1] // seq
    i, j = max(mesh.data_index, 0), mesh.seq_index
    return torch.from_numpy(np.ascontiguousarray(x[i * b:(i + 1) * b, j * t:(j + 1) * t]))


def sequence_parallel_worker(pid, n, cases):
    """Each case of ``cases`` (name -> dict: ``mesh`` (data, seq), q/k/v
    global arrays, the call's keyword arguments, ``dtype``, ``grad``):
    this rank's output shard and, with ``grad``, its q/k/v gradients of
    the global loss mean(y * y)."""
    import torch
    from deeplearning4j_tpu_torch.parallel import make_mesh, ring_attention, ulysses_attention
    from deeplearning4j_tpu_torch.parallel.unified import reset_exchange_stats
    meshes = {shape: make_mesh(data=shape[0], seq=shape[1], devices="cpu")
              for shape in sorted({c["mesh"] for c in cases.values()})}
    out = {"pid": pid}
    for name, case in cases.items():
        d, s = case["mesh"]
        mesh = meshes[case["mesh"]]
        dtype = getattr(torch, case.get("dtype", "float32"))
        q, k, v = (_shard(mesh, case[key], d, s).to(dtype).requires_grad_(case["grad"])
                   for key in ("q", "k", "v"))
        fn = ring_attention if case["fn"] == "ring" else ulysses_attention
        reset_exchange_stats()
        y = fn(q, k, v, mesh, **case["kw"])
        res = {"y": y.detach().float().numpy(), "index": (mesh.data_index, mesh.seq_index),
               "dtype": str(y.dtype).split(".")[1]}
        if case["grad"]:
            (y.float().pow(2).sum() / case["q"].size).backward()
            res["grads"] = [t.grad.numpy() for t in (q, k, v)]
        res["exchange"] = {kind: (st.calls, st.bytes)
                           for kind, st in reset_exchange_stats().items()}
        out[name] = res
    errors = {}
    try:
        ulysses_attention(*(torch.zeros(2, 4, 24) for _ in range(3)), meshes[(1, 4)],
                          n_heads=6)
    except ValueError as e:
        errors["heads"] = str(e)
    try:
        ring_attention(*(torch.zeros(2, 4, 24) for _ in range(3)), meshes[(1, 4)],
                       n_heads=6, head_axis="model")
    except NotImplementedError as e:
        errors["head_axis"] = str(e)
    out["errors"] = errors
    return out


# ------------------------------------------------------ expert parallelism
# tests/test_torch_expert_parallel.py's rank: moe_ffn on this rank's token
# shard over an ep2 mesh (ranks 0-1), an ep4 mesh and a dp2 x ep2 mesh of
# the gang of 4.

def expert_parallel_worker(pid, n, cases):
    """Each case of ``cases`` (name -> dict: ``mesh`` (data, expert), the
    MoE tree and the global tokens as numpy, the call's keyword
    arguments): this rank's output shard, its gradients of the global
    loss mean(y * y) in its params (the gate whole, its experts' rows)
    and its tokens, its shard's index, and the exchange counts of the
    forward and of the backward."""
    import torch
    from deeplearning4j_tpu_torch.parallel import make_mesh, moe_ffn, shard_moe_params
    from deeplearning4j_tpu_torch.parallel.unified import reset_exchange_stats
    meshes = {shape: make_mesh(data=shape[0], expert=shape[1], devices="cpu")
              for shape in sorted({c["mesh"] for c in cases.values()})}
    out = {"pid": pid}
    for name, case in cases.items():
        mesh = meshes[case["mesh"]]
        if not mesh.member:
            continue
        d, e = case["mesh"]
        shard = mesh.data_index * e + mesh.expert_index
        per = case["x"].shape[0] // (d * e)
        x = torch.from_numpy(case["x"][shard * per:(shard + 1) * per]).requires_grad_(True)
        params = {k: v.requires_grad_(True)
                  for k, v in shard_moe_params(
                      {k: torch.from_numpy(v) for k, v in case["params"].items()}, mesh).items()}
        reset_exchange_stats()
        y = moe_ffn(params, x, mesh, **case["kw"])
        fwd = reset_exchange_stats()
        (y.pow(2).sum() / (case["x"].shape[0] * case["x"].shape[1])).backward()
        bwd = reset_exchange_stats()
        out[name] = {"y": y.detach().numpy(), "shard": shard, "expert_index": mesh.expert_index,
                     "grads": {k: v.grad.numpy() for k, v in params.items()},
                     "gx": x.grad.numpy(),
                     "exchange": [{kind: (st.calls, st.bytes) for kind, st in s.items()}
                                  for s in (fwd, bwd)]}
    errors = {}
    mesh = meshes[(1, 2)]
    if mesh.member:
        three = {k: torch.from_numpy(v) for k, v in cases["ep2"]["params"].items()}
        three = {k: v[..., :3] if k == "gate" else v[:3] for k, v in three.items()}
        try:
            moe_ffn(three, torch.zeros(8, three["gate"].shape[0]), mesh)
        except ValueError as e:
            errors["experts"] = str(e)
        whole = {k: torch.from_numpy(v) for k, v in cases["ep2"]["params"].items()}
        x = torch.from_numpy(cases["ep2"]["x"][:cases["ep2"]["x"].shape[0] // 2])
        errors["whole_tree_equal"] = bool(torch.equal(
            moe_ffn(whole, x, mesh, **cases["ep2"]["kw"]),
            moe_ffn(shard_moe_params(whole, mesh), x, mesh, **cases["ep2"]["kw"])))
        try:
            moe_ffn({**whole, "w_in": whole["w_in"][:1]}, x, mesh)
        except ValueError as e:
            errors["rows"] = str(e)
    out["errors"] = errors
    return out


# ------------------------------------------------------------- pipelines
# tests/test_torch_pipeline.py's rank: the pipeline functions on this rank's
# stage over pipe-4, pipe-2 (ranks 0-1) and pipe-2 x data-2 meshes of the
# gang of 4.

def _mlp_stage(p, h):
    import torch
    return torch.tanh(h @ p["W"] + p["b"])


def _mse(out, lab):
    return ((out - lab) ** 2).mean()


def _rows(mesh, a, data: int):
    """This rank's data position's rows of the global numpy array ``a``."""
    import torch
    per = a.shape[0] // data
    i = max(mesh.data_index, 0)
    return torch.from_numpy(np.ascontiguousarray(a[i * per:(i + 1) * per]))


def _pipe_case(case, mesh):
    import torch
    from deeplearning4j_tpu_torch import interop
    from deeplearning4j_tpu_torch.models import bert
    from deeplearning4j_tpu_torch.parallel import pipeline, pipeline_stages as ps
    from deeplearning4j_tpu_torch.parallel.unified import reset_exchange_stats
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.train.updaters import tree_map
    kind, (S, d) = case["kind"], case["mesh"]
    x = _rows(mesh, case["x"], d)
    to_torch = functools.partial(tree_map, lambda a: torch.from_numpy(np.array(a)))
    if kind == "apply":
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        calls = get_registry().counter("tpudl_parallel_pipeline_calls_total")
        before = calls.value
        y = pipeline.pipeline_apply(_mlp_stage, to_torch(case["params"]), x, mesh, case["M"],
                                    data_axis="data" if d > 1 else None)
        return {"y": y.numpy(), "calls": calls.value - before}
    if kind == "apply_stages":
        return {"y": ps.pipeline_apply_stages([_mlp_stage] * S, to_torch(case["params"]), x,
                                              mesh, case["M"]).numpy()}
    y = _rows(mesh, case["y"], d)
    if kind == "train":
        out = {}
        for schedule in ("1f1b", "gpipe"):
            reset_exchange_stats()
            loss, grads = ps.pipeline_train_step(
                [_mlp_stage] * S, to_torch(case["params"]), x, y, _mse, mesh, case["M"],
                schedule=schedule, data_axis="data" if d > 1 else None)
            hops = reset_exchange_stats().get("pipe")
            out[schedule] = {"loss": float(loss),
                             "grads": tree_map(lambda t: t.numpy(), list(grads)),
                             "hops": None if hops is None else (hops.calls, hops.bytes)}
        return out
    if kind == "bert":
        config = bert.BertConfig.from_dict(case["config"])
        model = interop.load_jax_bert_params(bert.BertForMaskedLM(config, device="cpu"),
                                             case["params"])
        fns, sp = bert.pipeline_stages(config, model.params, S)
        loss, grads = ps.pipeline_train_step(fns, sp, x, y, bert.mlm_loss_from_logits, mesh,
                                             case["M"])
        merged = bert.merge_tied_embedding_grads(grads)
        return {"loss": float(loss), "grads": tree_map(lambda t: t.numpy(), list(merged))}
    if kind == "fit_local":
        tx = Adam(learning_rate=1e-2)
        flat, unravels, sizes = ps.flatten_stage_params(to_torch(case["params"]))
        row = ps.stage_row(flat, mesh)
        opt = ps.init_stage_local_opt(tx, flat, mesh)
        losses = []
        for _ in range(2):
            loss, row, opt = ps.pipeline_fit_step_local([_mlp_stage] * S, row, opt, tx,
                                                        unravels, sizes, x, y, _mse, mesh,
                                                        case["M"])
            losses.append(float(loss))
        back = ps.unflatten_stage_params(flat, unravels, sizes)
        return {"losses": losses, "row": row.numpy(), "sizes": sizes,
                "round_trip": [tree_map(lambda t: t.numpy(), b) for b in back]}
    raise ValueError(kind)


def pipeline_worker(pid, n, cases):
    """Each case of ``cases`` (name -> dict: ``kind``, ``mesh`` (pipe,
    data), the global numpy arrays and params): this rank's results, its
    pipe index; then the refusals' messages."""
    import torch
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.parallel import pipeline_stages as ps
    meshes = {shape: make_mesh(pipe=shape[0], data=shape[1], devices="cpu")
              for shape in sorted({c["mesh"] for c in cases.values()})}
    out = {"pid": pid}
    for name, case in cases.items():
        mesh = meshes[case["mesh"]]
        if mesh.member:
            out[name] = _pipe_case(case, mesh)
            out[name]["stage"] = mesh.pipe_index
    errors = {}
    mesh = meshes[(4, 1)]
    x = torch.zeros(16, 12)
    params = [{"W": torch.zeros(12, 12), "b": torch.zeros(12)}] * 4
    for key, call in {
            "model_axis": lambda: ps.pipeline_train_step([_mlp_stage] * 4, params, x, x, _mse,
                                                         mesh, 4, model_axis="model"),
            "uneven": lambda: ps.pipeline_train_step([_mlp_stage] * 4, params, x, x, _mse, mesh,
                                                     5),
            "fns": lambda: ps.pipeline_train_step([_mlp_stage] * 3, params, x, x, _mse, mesh, 4),
            "schedule": lambda: ps.pipeline_train_step([_mlp_stage] * 4, params, x, x, _mse,
                                                       mesh, 4, schedule="zb")}.items():
        try:
            call()
        except (ValueError, NotImplementedError) as e:
            errors[key] = f"{type(e).__name__}: {e}"
    out["errors"] = errors
    return out


# ------------------------------------------------------------ pipe layouts
# tests/test_torch_pipe_layout.py's rank: Trainer(layout="pp2") (ranks 0-1;
# 2-3 parked) and Trainer(layout="dp2xpp2") in the gang of 4.

def _pipe_fit(case, layout, mb=1, masks=None, listeners=()):
    """``_dp_fit`` under ``layout`` with ``mb`` microbatches, every dropout
    draw ``masks``' mask of its shape when given; the results and the
    trainer."""
    import torch
    from deeplearning4j_tpu_torch.nn.layers import base
    from deeplearning4j_tpu_torch.train import Trainer, step_cache
    step_cache.clear_step_cache()
    draw = base._keep_mask
    if masks is not None:
        base._keep_mask = lambda shape, p, gen, device: torch.as_tensor(masks[tuple(shape)])
    try:
        return _dp_fit(case, lambda net, ls: Trainer(net, ls, layout=layout, n_microbatches=mb),
                       listeners)
    finally:
        base._keep_mask = draw


def pipe_layout_worker(pid, n, spec_path):
    import os

    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    spec = _wait_for_spec(spec_path)
    drop, plain = spec["dropout"], spec["plain"]
    out = {"pid": pid}
    out["pp2_shared"], tr = _pipe_fit(drop, "pp2", masks=drop["masks"])
    out["parked"] = tr.parked
    out["step_key"] = tr._step_key("train")[-2] if tr._step_key("train") else None
    out["eager_reason"] = getattr(tr._step, "eager_reason", None)
    if not tr.parked:
        reg = get_registry()
        gauge = reg.labeled_gauge("tpudl_mesh_axis_size", label_names=("axis",))
        out["gauges"] = {"pipe": gauge.labeled_value(axis="pipe"),
                         "bytes": reg.gauge("tpudl_mesh_collective_bytes").value,
                         "param_bytes": sum(t.numel() * t.element_size()
                                            for t in tree_leaves(tr.net.params_))}
        batch = DataSet(drop["x"][:16], drop["y"][:16], np.ones((16, 8), np.float32))
        try:
            tr.fit_batch(batch)
        except ValueError as e:
            out["fmask_error"] = str(e)
        try:
            tr._fit_tbptt(batch, torch.Generator())
        except NotImplementedError as e:
            out["tbptt_error"] = str(e)
    out["pp2_own"], _ = _pipe_fit(drop, "pp2")
    out["single_own"], _ = _pipe_fit(drop, None)
    out["dp2xpp2"], tr = _pipe_fit(plain, "dp2xpp2", mb=2)
    out["dp2xpp2_key"] = tr._step_key("train")[-2]
    ckpt = os.path.join(spec["workdir"], f"ckpt_{pid}")
    got, tr = _pipe_fit(plain, "pp2", mb=2,
                        listeners=[CheckpointListener(ckpt, save_every_n_iterations=1)])
    out["pp2_mb2"] = got
    files = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    out["checkpoints"] = len([f for f in files if f.endswith(".zip")])
    if out["checkpoints"]:
        last = CheckpointListener.last_checkpoint_in(ckpt)
        out["checkpoint_params"] = _np(MultiLayerNetwork.load(last, device="cpu").params_)
    return out
