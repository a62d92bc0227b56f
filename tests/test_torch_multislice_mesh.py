"""``parallel.make_multislice_mesh`` on 8 ranks held to the JAX package's
``make_multislice_mesh`` on the conftest's 8 CPU devices: for (2, 4),
(4, 2), (8, 1) and (1, 8), each rank's (slice, data rank) is its device's
index in the reference's ``mesh.devices``, and the subgroups it makes
hold the ranks that index says (an all-reduce of the rank ids over each
slice's groups and over the leaders' group, a broadcast from the slice's
leader over its relay group).  One gang of 8 gloo processes on the CPU
(``tests/torch_cluster_workers.py::mesh_worker``)."""

import functools

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.parallel import dcn as jdcn

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch.parallel import spawn_local_cluster

GANG_PORT = 16111
SHAPES = ((2, 4), (4, 2), (8, 1), (1, 8))


@pytest.fixture(scope="module")
def ranks():
    out = spawn_local_cluster(functools.partial(workers.mesh_worker, shapes=SHAPES),
                              n_processes=8, port=GANG_PORT, timeout=120.0)
    return sorted(out, key=lambda r: r["pid"])


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s}x{d}" for s, d in SHAPES])
def test_eight_rank_mesh_follows_the_reference(ranks, shape):
    assert len(ranks) == 8 and len(jax.devices()) >= 8
    ref = jdcn.make_multislice_mesh(*shape, devices=jax.devices()[:8])
    assert tuple(ref.axis_names) == ("dcn", "data", "model")
    n_slices, d = shape
    for r in ranks:
        got = r[shape]
        where = tuple(int(i) for i in np.argwhere(ref.devices == jax.devices()[r["pid"]])[0])
        assert got["position"] == where
        assert got["shape"] == dict(ref.shape)
        s, j, _ = where
        members = [int(dev.id) for dev in ref.devices[s, :, 0]]
        leaders = [int(dev.id) for dev in ref.devices[:, 0, 0]]
        assert got["leader"] == (j == 0)
        assert got["sums"]["slice"] == got["sums"]["relay"] == sum(members)
        assert got["sums"]["relayed_from"] == members[0]
        if got["leader"]:
            assert got["sums"]["leaders"] == sum(leaders)
        assert got["layout"] == ("single" if d == 1 else f"dp{d}")
