"""The port's gradient codecs held to the JAX package's, bit for bit.

``parallel/compression.py`` of the port keeps its own copy of the numpy
codecs and writes the device twins in torch; both must give the JAX
package's messages exactly (a wire index is a position in the flat
parameter vector, a value is an f32's bits), since slices of the two
packages would otherwise disagree on the update.  Inputs are seeded
normals of 5000 entries with planted ties: 40 entries at +0.25 and 40 at
-0.25, and capacities that put the overflow boundary inside that tie
group (ties go to the lower index), at the hit count exactly, and above
it.  Every comparison is exact (``np.array_equal`` of the int32 bits);
there is no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import compression as J
from deeplearning4j_tpu_torch.parallel import compression as T

N, TAU, TIE = 5000, 0.2, 0.25


@pytest.fixture(scope="module")
def grad():
    g = np.random.default_rng(31).normal(0, 0.1, N).astype(np.float32)
    g[100:140] = TIE
    g[2000:2040] = -TIE
    return g


def _caps(g):
    """Capacities: inside the tie group at the boundary (overflow), the hit
    count exactly, and twice it (no overflow)."""
    above = int(np.sum(np.abs(g) > TIE))
    hits = int(np.sum(np.abs(g) >= TAU))
    assert above < above + 30 < above + 80 <= hits
    return {"ties": above + 30, "exact": hits, "under": 2 * hits}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b):
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", ["ties", "exact", "under"])
@pytest.mark.parametrize("mode", ["sign", "value"])
def test_device_encode_matches_jax(grad, mode, case):
    cap = _caps(grad)[case]
    name = "threshold_encode_device" if mode == "sign" else "threshold_encode_values_device"
    want = np.asarray(getattr(J, name)(jnp.asarray(grad), TAU, cap))
    got = getattr(T, name)(_t(grad), TAU, cap).numpy()
    assert _same(got, want)
    assert int(got[0]) == min(cap, int(np.sum(np.abs(grad) >= TAU)))
    # a threshold given as a device scalar (the captured step's way) gives the same bits
    got_t = getattr(T, name)(_t(grad), torch.tensor(TAU, dtype=torch.float32), cap).numpy()
    assert _same(got_t, want)


@pytest.mark.parametrize("with_out", [False, True])
@pytest.mark.parametrize("mode", ["sign", "value"])
def test_device_decode_matches_jax(grad, mode, with_out):
    cap = _caps(grad)["ties"]
    out = np.random.default_rng(5).normal(size=N).astype(np.float32) if with_out else None
    if mode == "sign":
        msg = np.asarray(J.threshold_encode_device(jnp.asarray(grad), TAU, cap))
        want = J.threshold_decode_device(jnp.asarray(msg), N,
                                         None if out is None else jnp.asarray(out))
        got = T.threshold_decode_device(_t(msg), N, None if out is None else _t(out))
    else:
        msg = np.asarray(J.threshold_encode_values_device(jnp.asarray(grad), TAU, cap))
        want = J.threshold_decode_values_device(jnp.asarray(msg), N, cap,
                                                None if out is None else jnp.asarray(out))
        got = T.threshold_decode_values_device(_t(msg), N, cap, None if out is None else _t(out))
    assert _same(got.numpy(), want)


@pytest.mark.parametrize("size", [N, N - 1])
def test_bitmap_device_matches_jax(grad, size):
    g = grad[:size]
    jp, jh = J.bitmap_encode_device(jnp.asarray(g), TAU)
    tp, th = T.bitmap_encode_device(_t(g), TAU)
    assert _same(tp.numpy(), jp) and _same(th.numpy(), jh)
    hp, hh = J.bitmap_encode(g, TAU)
    assert _same(tp.numpy(), hp) and np.array_equal(th.numpy().astype(np.int64), hh)
    out = np.random.default_rng(6).normal(size=size).astype(np.float32)
    assert _same(T.bitmap_decode_device(tp, th, size).numpy(), J.bitmap_decode_device(jp, jh, size))
    assert _same(T.bitmap_decode_device(tp, th, size, _t(out)).numpy(),
                 J.bitmap_decode_device(jp, jh, size, jnp.asarray(out)))


@pytest.mark.parametrize("mode", ["sign", "value"])
def test_compact_and_pad_round_trip_match_jax(grad, mode):
    cap = _caps(grad)["under"]
    name = "threshold_encode_device" if mode == "sign" else "threshold_encode_values_device"
    msg = np.asarray(getattr(J, name)(jnp.asarray(grad), TAU, cap))
    compact = T.compact_device_message(msg, cap)
    assert _same(compact, J.compact_device_message(msg, cap))
    host = (J.threshold_encode if mode == "sign" else J.threshold_encode_values)(grad, TAU)
    assert _same(compact, host)      # the exact host wire format
    assert _same(T.pad_to_device_layout(compact, cap), msg)
    assert _same(T.pad_to_device_layout(compact, cap), J.pad_to_device_layout(compact, cap))
    with pytest.raises(ValueError, match="exceeds capacity"):
        T.pad_to_device_layout(compact, int(compact[0]) - 1)


@pytest.mark.parametrize("case", ["ties", "under"])
@pytest.mark.parametrize("mode", ["sign", "value"])
def test_host_codecs_match_jax(grad, mode, case):
    cap = _caps(grad)[case]
    enc = "threshold_encode" if mode == "sign" else "threshold_encode_values"
    want = getattr(J, enc)(grad, TAU, max_elements=cap)
    got = getattr(T, enc)(grad, TAU, max_elements=cap)
    assert _same(got, want)
    # the host codec and the device twin give one wire under overflow
    dev = "threshold_encode_device" if mode == "sign" else "threshold_encode_values_device"
    assert _same(T.compact_device_message(getattr(T, dev)(_t(grad), TAU, cap).numpy(), cap), got)
    out = np.random.default_rng(7).normal(size=N).astype(np.float32)
    assert _same(T.threshold_decode(got, (N,)), J.threshold_decode(want, (N,)))
    assert _same(T.threshold_decode(got, (N,), out=out.copy()),
                 J.threshold_decode(want, (N,), out=out.copy()))


def test_largest_by_magnitude_matches_jax(grad):
    hits = np.nonzero(np.abs(grad) >= TAU)[0]
    for k in (1, 40, _caps(grad)["ties"], hits.size):
        assert _same(T._largest_by_magnitude(grad, hits, k), J._largest_by_magnitude(grad, hits, k))


def test_adaptive_threshold_sequence_matches_jax():
    rng = np.random.default_rng(8)
    kw = dict(initial_threshold=3e-2, target_sparsity=1e-2, decay=0.9)
    a, b = T.AdaptiveThresholdAlgorithm(**kw), J.AdaptiveThresholdAlgorithm(**kw)
    seq_a, seq_b = [], []
    for n in rng.integers(0, 200, 60):
        seq_a.append(a.update(int(n), 4000))
        seq_b.append(b.update(int(n), 4000))
    assert seq_a == seq_b and a.current() == b.current()
    assert T.AdaptiveThresholdAlgorithm().current() == J.AdaptiveThresholdAlgorithm().current()


@pytest.mark.parametrize("cap", [None, 40])
@pytest.mark.parametrize("value_coded", [False, True])
def test_accumulator_over_five_steps_matches_jax(value_coded, cap):
    """Five steps of residual + encode + error feedback: the same messages,
    residuals and thresholds (the JAX package's native codec, where built,
    is held to its numpy codec bit for bit by its own tests)."""
    rng = np.random.default_rng(9)
    kw = dict(value_coded=value_coded, max_elements=cap)
    a = T.EncodedGradientsAccumulator((40, 25), T.AdaptiveThresholdAlgorithm(2e-2), **kw)
    b = J.EncodedGradientsAccumulator((40, 25), J.AdaptiveThresholdAlgorithm(2e-2), **kw)
    for _ in range(5):
        g = rng.normal(0, 0.02, (40, 25)).astype(np.float32)
        assert _same(a.store_update(g), b.store_update(g))
        assert _same(a.residual, b.residual)
        assert a.algorithm.current() == b.algorithm.current()
    target = rng.normal(size=(40, 25)).astype(np.float32)
    msg = a.store_update(np.zeros((40, 25), np.float32))
    assert _same(a.apply_update(msg, target.copy()), b.apply_update(msg, target.copy()))
