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
