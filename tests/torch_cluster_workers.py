"""Workers that the port's multi-process tests run in child processes of
``deeplearning4j_tpu_torch.parallel.launcher.spawn_local_cluster``
(module-level, so that they pickle by name; they import nothing of JAX)."""

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
