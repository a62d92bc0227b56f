"""The port's int8 dequant-matmul and weight quantization held to the JAX
package.

The same numpy inputs, made from a seed, go through the JAX functions
and the port's.  ``int8_matmul_plain`` is held to ``int8_matmul_pallas``
in interpret mode at small ragged shapes, and to ``int8_matmul_reference``
at VGG-16's fc8 shape, which the Pallas kernel refuses when it must keep
the whole weight resident (its VMEM check; the port's kernel streams the
weight and has no such limit).  Both sides sum in f32 and differ in order
only: f32 within 1e-5 of the largest |y|; bf16 within one bf16 ulp of
each entry, ``|diff| <= 2^-7 |y| + 1e-6 max |y|`` (the two f32 sums may
round to neighbouring bf16 values), as chip_smoke.py holds the CUDA
kernel to the plain version.  ``quantize_weight`` and
``dequantize_weight`` must equal JAX's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import quantize as jquantize
from deeplearning4j_tpu.ops.pallas.quant_matmul import int8_matmul_pallas, int8_matmul_reference

import chip_smoke
from deeplearning4j_tpu_torch.nn import quantize
from deeplearning4j_tpu_torch.ops.kernels import quant_matmul as qm

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _operands(m, k, n, dname, seed=0):
    """x in the dtype (as a torch tensor and a jnp array holding the same
    values), int8 w_q and f32 per-column scale."""
    rng = np.random.default_rng(seed)
    tdt, jdt = DTYPES[dname]
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(tdt)
    w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    xj = jnp.asarray(x.float().numpy()).astype(jdt)   # exact: x holds dtype values
    return (x, torch.from_numpy(w_q), torch.from_numpy(scale)), (xj, jnp.asarray(w_q),
                                                                 jnp.asarray(scale))


def _assert_within_limit(got, want_jax, dname):
    want = torch.from_numpy(np.array(want_jax.astype(jnp.float32)))
    assert got.dtype == DTYPES[dname][0] and tuple(got.shape) == tuple(want.shape)
    over = chip_smoke.int8_over_limit(got, want, dname)
    assert over <= 1.0, f"{over:.3g} times the limit"


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("n", [48, 100])
@pytest.mark.parametrize("k", [64, 96])
@pytest.mark.parametrize("m", [5, 37])
def test_plain_matches_pallas_kernel(m, k, n, dname):
    (x, w_q, scale), jargs = _operands(m, k, n, dname, seed=m + k + n)
    want = int8_matmul_pallas(*jargs, interpret=True)
    _assert_within_limit(qm.int8_matmul_plain(x, w_q, scale), want, dname)


@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_plain_matches_reference_at_vgg16_fc8(dname):
    (x, w_q, scale), jargs = _operands(8, 4096, 1000, dname, seed=8)
    _assert_within_limit(qm.int8_matmul_plain(x, w_q, scale), int8_matmul_reference(*jargs),
                         dname)


def test_pallas_kernel_refuses_vgg16_fc6_that_the_port_takes():
    """The reference's resident-weight limit (queue C of ROADMAP.md): the
    Pallas kernel raises for fc6's [25088, 4096] weight at build time."""
    x = jnp.zeros((1, 25088), jnp.bfloat16)
    with pytest.raises(ValueError, match="cannot fit"):
        int8_matmul_pallas(x, jnp.zeros((25088, 4096), jnp.int8), jnp.ones((4096,)),
                           interpret=True)


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    (x, w_q, scale), _ = _operands(9, 96, 100, "bfloat16", seed=3)
    before = qm.launches
    torch.testing.assert_close(qm.int8_matmul(x, w_q, scale), qm.int8_matmul_plain(x, w_q, scale),
                               rtol=0, atol=0)
    x64 = x.to(torch.float64)
    assert qm.int8_matmul(x64, w_q, scale).dtype == torch.float64
    assert qm.launches == before


def test_smoke_check_sees_each_planted_fault():
    """chip_smoke.py's planted faults read far past the limit here too:
    the scale dropped, and the last K split skipped."""
    (x, w_q, scale), _ = _operands(7, 1024, 10, "bfloat16", seed=4)
    want = qm.int8_matmul_plain(x, w_q, scale)
    splits, per = qm.k_splits(1024, 10, 132, qm.TILE_N[torch.bfloat16])
    skipped = x.clone()
    skipped[:, (splits - 1) * per:] = 0
    for fault in (qm.int8_matmul_plain(x, w_q, torch.ones_like(scale)),
                  qm.int8_matmul_plain(skipped, w_q, scale)):
        assert chip_smoke.int8_over_limit(fault, want, "bfloat16") > 10 * chip_smoke.INT8_FAULT_MARGIN


@pytest.mark.parametrize("k,n", [(25088, 4096), (4096, 4096), (4096, 1000), (1024, 1024),
                                 (1024, 10), (64, 48), (96, 100)])
@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_k_splits_cover_k_in_whole_chunks(k, n, sms, dname):
    tile = qm.TILE_N[DTYPES[dname][0]]
    splits, per = qm.k_splits(k, n, sms, tile)
    assert per % qm.KC == 0 and per >= min(qm.MIN_SPLIT_K, qm.KC * -(-k // qm.KC))
    assert (splits - 1) * per < k <= splits * per
    assert splits * -(-n // tile) <= qm.BLOCKS_PER_SM * sms + -(-n // tile)


def _weights(shape, dname, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    w[..., 0] = 0.0                      # an all-zero channel: the eps floor
    w[..., 1] *= 40.0                    # a wide one
    tw = torch.from_numpy(w).to(DTYPES[dname][0])
    return tw, jnp.asarray(tw.float().numpy()).astype(DTYPES[dname][1])


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(300, 48), (3, 3, 8, 16)])
def test_quantize_weight_matches_jax_bit_for_bit(shape, dname):
    tw, jw = _weights(shape, dname, seed=len(shape))
    w_q, scale = quantize.quantize_weight(tw)
    jw_q, jscale = jquantize.quantize_weight(jw)
    assert w_q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    for tdt, jdt in DTYPES.values():
        back = quantize.dequantize_weight(w_q, scale, tdt)
        jback = jquantize.dequantize_weight(jw_q, jscale, jdt)
        assert back.dtype == tdt
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(jback.astype(jnp.float32)))
