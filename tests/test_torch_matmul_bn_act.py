"""The port's matmul_bn_act and FusedBottleneck held to the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernel in interpret mode on the CPU) and through the port's plain
PyTorch version.  Bands are the JAX kernel test's own: y at 1e-5, the
per-column statistics at 1e-3, a whole bottleneck at 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers.fused import FusedBottleneck as JFusedBottleneck
from deeplearning4j_tpu.ops.pallas.conv_bn import matmul_bn_act as jax_matmul_bn_act

from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneck
from deeplearning4j_tpu_torch.ops.kernels import conv_bn


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            (rng.normal(size=(k, n)) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, k).astype(np.float32),
            (rng.normal(size=k) * 0.2).astype(np.float32))


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("relu_in", [False, True])
def test_plain_matches_jax_kernel(prologue, relu_in):
    x, w, a, b = _inputs(300, 32, 48)   # 300 rows: a ragged last block of 64
    jargs = (jnp.asarray(x), jnp.asarray(w)) + ((jnp.asarray(a), jnp.asarray(b)) if prologue else ())
    targs = (torch.from_numpy(x), torch.from_numpy(w)) + (
        (torch.from_numpy(a), torch.from_numpy(b)) if prologue else ())
    yj, s1j, s2j = jax_matmul_bn_act(*jargs, relu_in=relu_in, block_m=64)
    yt, s1t, s2t = conv_bn.matmul_bn_act_plain(*targs, relu_in=relu_in)
    assert yt.dtype == torch.float32 and s1t.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s1t.numpy(), np.asarray(s1j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(s2t.numpy(), np.asarray(s2j), rtol=1e-4, atol=1e-3)


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    x, w, a, b = (torch.from_numpy(t) for t in _inputs(70, 32, 64, seed=1))
    before = conv_bn.launches
    got = conv_bn.matmul_bn_act(x, w, a, b, relu_in=True)
    want = conv_bn.matmul_bn_act_plain(x, w, a, b, relu_in=True)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    assert conv_bn.launches == before


def test_f64_takes_the_exact_branch():
    import jax
    x, w, a, b = _inputs(40, 32, 32, seed=2)
    jax.config.update("jax_enable_x64", True)
    try:
        yj, s1j, s2j = (np.asarray(t) for t in jax_matmul_bn_act(
            *(jnp.asarray(t, jnp.float64) for t in (x, w, a, b)), relu_in=True))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert yj.dtype == np.float64
    yt, s1t, s2t = conv_bn.matmul_bn_act(*(torch.from_numpy(t).double() for t in (x, w, a, b)),
                                         relu_in=True)
    assert yt.dtype == torch.float64 and s2t.dtype == torch.float64
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s1t.numpy(), s1j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(s2t.numpy(), s2j, rtol=1e-10, atol=1e-10)


def test_bf16_plain_rounds_the_prologue_like_jax():
    x, w, a, b = _inputs(64, 32, 32, seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    yj, s1j, s2j = jax_matmul_bn_act(xb, wb, jnp.asarray(a), jnp.asarray(b), relu_in=True)
    yt, s1t, s2t = conv_bn.matmul_bn_act_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(a), torch.from_numpy(b), relu_in=True)
    assert yt.dtype == torch.bfloat16
    # y: one bf16 rounding apart at most; stats: f32 sums of the same y
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(s1t.numpy(), np.asarray(s1j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(s2t.numpy(), np.asarray(s2j), rtol=1e-4, atol=1e-3)


def _random_block_state(jparams, jstate, rng):
    """Non-trivial BN: running stats, gamma and beta all drawn."""
    params = {k: np.array(v, np.float32) for k, v in jparams.items()}
    state = {}
    for k, v in jstate.items():
        n = np.asarray(v).shape[0]
        state[k] = (rng.normal(0, 0.2, n) if k.startswith("mean")
                    else rng.uniform(0.5, 1.5, n)).astype(np.float32)
    for k in params:
        if k.startswith("gamma"):
            params[k] = rng.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
        elif k.startswith("beta"):
            params[k] = rng.normal(0, 0.2, params[k].shape).astype(np.float32)
    return params, state


@pytest.mark.parametrize("project", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_fused_bottleneck_eval_matches_jax(project, stride):
    import jax
    rng = np.random.default_rng(10 + 2 * stride + project)
    c_in = 32 if not project else 16
    filters = (8, 16, 32)
    itype = JInputType.convolutional(8, 8, c_in)
    jlayer = JFusedBottleneck(filters=filters, stride=(stride, stride), project=project)
    jparams = jlayer.init_params(jax.random.key(0), itype)
    params, state = _random_block_state(jparams, jlayer.init_state(itype), rng)
    x = rng.normal(size=(2, 8, 8, c_in)).astype(np.float32)

    yj, _ = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()},
                         {k: jnp.asarray(v) for k, v in state.items()},
                         jnp.asarray(x), train=False)
    tlayer = FusedBottleneck(filters=filters, stride=(stride, stride), project=project)
    yt, st = tlayer.apply({k: torch.from_numpy(v) for k, v in params.items()},
                          {k: torch.from_numpy(v) for k, v in state.items()},
                          torch.from_numpy(x), train=False)
    assert tuple(yt.shape) == tuple(yj.shape)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4, atol=2e-4)
    with pytest.raises(NotImplementedError):
        tlayer.apply({k: torch.from_numpy(v) for k, v in params.items()}, st,
                     torch.from_numpy(x), train=True)


def test_fused_bottleneck_bf16_policy_matches_jax():
    """Under both packages' bf16 policy (bf16 compute and outputs, f32
    params): the block computes in bf16 end to end.  Band 5e-2 on O(1)
    outputs: several bf16 roundings (2^-8 relative each) in another order."""
    import jax
    from deeplearning4j_tpu import config as jconfig
    from deeplearning4j_tpu_torch import config as tconfig

    rng = np.random.default_rng(21)
    itype = JInputType.convolutional(8, 8, 16)
    jlayer = JFusedBottleneck(filters=(8, 16, 32), stride=(2, 2), project=True)
    params, state = _random_block_state(jlayer.init_params(jax.random.key(1), itype),
                                        jlayer.init_state(itype), rng)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    jconfig.set_dtype_policy(jconfig.DTypePolicy.bf16())
    tconfig.set_dtype_policy(tconfig.DTypePolicy.bf16())
    try:
        yj, _ = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in state.items()},
                             jnp.asarray(x), train=False)
        yt, _ = FusedBottleneck(filters=(8, 16, 32), stride=(2, 2), project=True).apply(
            {k: torch.from_numpy(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(x), train=False)
    finally:
        jconfig.set_dtype_policy(jconfig.DTypePolicy.f32())
        tconfig.set_dtype_policy(tconfig.DTypePolicy.f32())
    assert yt.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               rtol=5e-2, atol=5e-2)
