"""The port's matmul_bn_act and FusedBottleneck held to the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernel in interpret mode on the CPU) and through the port's plain
PyTorch version.  Bands are the JAX kernel test's own: y at 1e-5, the
per-column statistics at 1e-3, a whole bottleneck at 2e-4.  In train
mode a bottleneck's output and running statistics are held at 1e-5 and
the gradients of sum(out^2) at 1e-4 relative to each gradient's largest
entry: both sides compute in f32, in other summation orders.
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
    for k, v in st.items():   # eval leaves the running statistics as they were
        np.testing.assert_array_equal(v.numpy(), state[k])


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


@pytest.mark.parametrize("project,stride,cin", [(True, (1, 1), 16), (True, (2, 2), 32),
                                                (False, (1, 1), 32)])
def test_fused_bottleneck_train_matches_jax(project, stride, cin):
    """Batch statistics from the kernel's s1/s2 (and the 3x3's reduction),
    the running-statistics update, and gradients through the statistics
    into the merged backward."""
    import jax
    rng = np.random.default_rng(30 + cin + stride[0] + project)
    filters = (8, 8, 32)
    itype = JInputType.convolutional(8, 8, cin)
    jlayer = JFusedBottleneck(filters=filters, stride=stride, project=project)
    params, state = _random_block_state(jlayer.init_params(jax.random.key(2), itype),
                                        jlayer.init_state(itype), rng)
    x = rng.normal(size=(4, 8, 8, cin)).astype(np.float32)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}

    def jloss(p):
        out, new_state = jlayer.apply(p, jstate, jnp.asarray(x), train=True)
        return jnp.sum(out ** 2), (out, new_state)

    jgrads, (yj, sj) = jax.grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})

    tlayer = FusedBottleneck(filters=filters, stride=stride, project=project)
    tparams = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    yt, st = tlayer.apply(tparams, tstate, torch.from_numpy(x), train=True)
    tgrads = torch.autograd.grad((yt ** 2).sum(), list(tparams.values()))

    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    assert set(st) == set(sj)
    for k in st:
        assert not st[k].requires_grad
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        assert not np.allclose(st[k].numpy(), state[k])   # the running stats moved
    for k, g in zip(tparams, tgrads):
        e = np.asarray(jgrads[k])
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-4 * np.abs(e).max(),
                                   err_msg=k)


@pytest.mark.parametrize("project,stride,cin", [(True, (1, 1), 16), (True, (2, 2), 32),
                                                (False, (1, 1), 32)])
def test_fused_bottleneck_train_bf16_matches_jax(project, stride, cin):
    """The train branch under both packages' bf16 policy: one block, so
    its bf16 roundings do not compound as they do over a whole net.
    Bands: the output at 1e-2 of its largest entry (reads 0), the running
    statistics at 1e-5 of theirs (f32 sums of the same products; reads
    9e-8), and each param's gradient of sum(out^2) within 0.15 of its
    norm (reads at most 8.3%, beta_b3; the reference's own bf16 gradients
    lie up to 17% from the f64 ones)."""
    import jax
    from deeplearning4j_tpu import config as jconfig
    from deeplearning4j_tpu_torch import config as tconfig

    rng = np.random.default_rng(30 + cin + stride[0] + project)
    filters = (8, 8, 32)
    itype = JInputType.convolutional(8, 8, cin)
    jlayer = JFusedBottleneck(filters=filters, stride=stride, project=project)
    params, state = _random_block_state(jlayer.init_params(jax.random.key(2), itype),
                                        jlayer.init_state(itype), rng)
    x = rng.normal(size=(4, 8, 8, cin)).astype(np.float32)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}

    def jloss(p):
        out, new_state = jlayer.apply(p, jstate, jnp.asarray(x), train=True)
        return jnp.sum(out.astype(jnp.float32) ** 2), (out, new_state)

    jconfig.set_dtype_policy(jconfig.DTypePolicy.bf16())
    tconfig.set_dtype_policy(tconfig.DTypePolicy.bf16())
    try:
        jgrads, (yj, sj) = jax.grad(jloss, has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()})
        tlayer = FusedBottleneck(filters=filters, stride=stride, project=project)
        tparams = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
        yt, st = tlayer.apply(tparams, {k: torch.from_numpy(v) for k, v in state.items()},
                              torch.from_numpy(x), train=True)
        tgrads = torch.autograd.grad((yt.float() ** 2).sum(), list(tparams.values()))
    finally:
        jconfig.set_dtype_policy(jconfig.DTypePolicy.f32())
        tconfig.set_dtype_policy(tconfig.DTypePolicy.f32())

    assert yt.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    e = np.asarray(yj, np.float32)
    np.testing.assert_allclose(yt.detach().float().numpy(), e, rtol=0,
                               atol=1e-2 * np.abs(e).max())
    assert set(st) == set(sj)
    for k in st:
        e = np.asarray(sj[k])
        np.testing.assert_allclose(st[k].numpy(), e, rtol=0, atol=1e-5 * np.abs(e).max(),
                                   err_msg=k)
    for k, g in zip(tparams, tgrads):
        e = np.asarray(jgrads[k], np.float64)
        err = np.linalg.norm(g.double().numpy() - e) / np.linalg.norm(e)
        assert g.dtype == torch.float32 and err <= 0.15, f"{k}: {err:.3g} of its norm"
