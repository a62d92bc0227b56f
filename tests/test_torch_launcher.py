"""The port's launcher (``parallel/launcher.py``): a real two-process gang
under a gloo process group on the CPU.

The tentpole check: two processes, each one slice leader of
``MultiSliceTrainer(world_size=2)`` over a loopback ``SocketTransport``
ring with the device codec and the overlapped exchange, end with params
bit-equal to the port's in-process two-slice run on the same data (slice
i takes rows i::2 of each global batch in both), and each step's mean of
the two processes' losses equals the in-process step's loss exactly: the
same arithmetic in the same order, so no tolerance.  A failing child
raises with its traceback and its flight-recorder dump.
"""

import functools

import numpy as np
import pytest

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.parallel import MultiSliceTrainer, launcher
from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector

GANG_PORT, RING_PORT = 13611, 13621


def _in_process():
    net = workers.dense_net()
    tr = MultiSliceTrainer(net, 2, devices=["cpu"] * 2, overlap=True,
                           algorithm=workers.algorithm())
    losses = [tr.fit_batch(DataSet(np.concatenate([x[0::2], x[1::2]]),
                                   np.concatenate([y[0::2], y[1::2]])))
              for x, y in workers.global_batches()]
    tr.collect()
    tr.close()
    return losses, flat_param_vector(net.params_).numpy()


def test_two_processes_match_the_in_process_two_slices():
    results = launcher.spawn_local_cluster(
        functools.partial(workers.dcn_fit_worker, ring_port=RING_PORT), n_processes=2,
        port=GANG_PORT, timeout=120.0)
    a, b = sorted(results, key=lambda r: r["pid"])
    assert a["world"] == b["world"] == 2 and a["all_equal"] and b["all_equal"]
    assert a["bytes_sent"] > 0 and b["bytes_sent"] > 0
    losses, params = _in_process()
    assert np.array_equal(a["params"].view(np.int32), params.view(np.int32))
    assert [float(np.mean([x, y])) for x, y in zip(a["losses"], b["losses"])] == losses


def test_a_failing_child_raises_with_its_traceback_and_black_box():
    with pytest.raises(RuntimeError, match="planted failure in rank 1") as info:
        launcher.spawn_local_cluster(workers.failing_worker, n_processes=2, port=GANG_PORT + 40,
                                     timeout=120.0, startup_retries=0)
    assert "process 1 rc=1" in str(info.value)
    header = next(e for e in info.value.flight_dumps[1] if e.get("type") == "header")
    assert header["reason"] == "unhandled_exception"


def test_startup_flakes_and_helpers():
    assert launcher._is_startup_flake(RuntimeError("bind: Address already in use"))
    assert launcher._is_startup_flake(ConnectionError("refused"))
    assert not launcher._is_startup_flake(launcher.ClusterTimeoutError("address already in use"))
    assert not launcher._is_startup_flake(launcher.ClusterStallError("stall"))
    assert not launcher._is_startup_flake(RuntimeError("local cluster failed: rc=1"))
    assert launcher._device_of(None, 1) is None
    assert launcher._device_of("cuda:0", 1) == "cuda:0"
    assert launcher._device_of(["cpu", "cuda:1"], 1) == "cuda:1"
    assert launcher._dump_summary({}) == "no flight-recorder dumps found"
    line = launcher._dump_summary({0: [{"type": "header", "reason": "watchdog"},
                                       {"type": "liveness", "last_site": "dcn.exchange",
                                        "stalled_for_s": 5.0}, {"type": "thread"}]})
    assert "reason=watchdog" in line and "last_site=dcn.exchange" in line
    assert "1 thread stacks" in line
    launcher.initialize(num_processes=1)                 # one process: nothing to do
    with pytest.raises(ValueError, match="coordinator_address"):
        launcher.initialize(num_processes=2)
