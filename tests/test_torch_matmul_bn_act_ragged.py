"""matmul_bn_act and FusedBottleneck at channel counts that are no
multiples of 32, held to the JAX package.

The CUDA kernels take any K and N (a ragged template loads element by
element and guards the K and N tails); their plain versions, which the
port runs for CPU tensors, are held here to the JAX function (its Pallas
kernels in interpret mode, block_m=64 at M=300, so the last block is
padded) at K and N of 4, 8, 24 and 100, and FusedBottleneck to the JAX
layer at the reference's own ragged filters (4, 4, 8) and (8, 8, 32)
(``tests/test_conv_bn_fused.py``).  Bands are the existing matmul_bn_act
tests': y at 1e-5, statistics at 1e-3, the backward at 1e-4 in f32 and
1e-2 in bf16; a bottleneck's eval output at 2e-4, its train output and
running statistics at 1e-5 and its gradients at 1e-4 of each gradient's
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers.fused import FusedBottleneck as JFusedBottleneck
from deeplearning4j_tpu.ops.pallas.conv_bn import matmul_bn_act as jax_matmul_bn_act

from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneck
from deeplearning4j_tpu_torch.ops.kernels import conv_bn

M = 300
KN = [(4, 8), (8, 4), (24, 100), (100, 24)]


def _inputs(k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, k)).astype(np.float32),
            (rng.normal(size=(k, n)) * 0.3).astype(np.float32),
            rng.uniform(0.5, 1.5, k).astype(np.float32),
            (rng.normal(size=k) * 0.2).astype(np.float32),
            rng.normal(size=(M, n)).astype(np.float32),
            (rng.normal(size=n) * 0.3).astype(np.float32),
            (rng.normal(size=n) * 0.1).astype(np.float32))


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("k,n", KN)
def test_plain_matches_jax_at_ragged_k_and_n(k, n, prologue):
    x, w, a, b, dy, ds1, ds2 = _inputs(k, n, seed=k * 1000 + n)
    jprims = [jnp.asarray(x), jnp.asarray(w)] + ([jnp.asarray(a), jnp.asarray(b)] if prologue
                                                 else [])
    (yj, s1j, s2j), vjp = jax.vjp(
        lambda *p: jax_matmul_bn_act(*p, relu_in=True, block_m=64), *jprims)
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(ds1), jnp.asarray(ds2)))
    ta, tb = (torch.from_numpy(a), torch.from_numpy(b)) if prologue else (None, None)
    yt, s1t, s2t = conv_bn.matmul_bn_act_plain(torch.from_numpy(x), torch.from_numpy(w), ta, tb,
                                               relu_in=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s1t.numpy(), np.asarray(s1j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(s2t.numpy(), np.asarray(s2j), rtol=1e-4, atol=1e-3)
    got = conv_bn.matmul_bn_act_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(w), ta, tb, torch.from_numpy(np.array(yj)),
        torch.from_numpy(dy), torch.from_numpy(ds1), torch.from_numpy(ds2), relu_in=True)
    got = [g for g in got if g is not None]
    assert len(got) == len(jgrads) == (4 if prologue else 2)
    for name, g, e in zip(("dx", "dw", "da", "db"), got, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("k,n", KN[:2])
def test_plain_backward_matches_jax_at_ragged_k_and_n_bf16(k, n):
    x, w, a, b, dy, ds1, ds2 = _inputs(k, n, seed=7 + k + n)
    bf = jnp.bfloat16
    (yj, _, _), vjp = jax.vjp(lambda *p: jax_matmul_bn_act(*p, relu_in=True, block_m=64),
                              jnp.asarray(x, bf), jnp.asarray(w, bf), jnp.asarray(a),
                              jnp.asarray(b))
    jgrads = vjp((jnp.asarray(dy, bf), jnp.asarray(ds1), jnp.asarray(ds2)))
    def t(v):
        return torch.from_numpy(np.array(jnp.asarray(v, bf).astype(jnp.float32))).bfloat16()

    got = conv_bn.matmul_bn_act_bwd_plain(
        t(x), t(w), torch.from_numpy(a), torch.from_numpy(b), t(yj), t(dy),
        torch.from_numpy(ds1), torch.from_numpy(ds2), relu_in=True)
    for name, g, e in zip(("dx", "dw", "da", "db"), got, jgrads):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(e, np.float32), rtol=1e-2,
                                   atol=1e-2, err_msg=name)


def _block(filters, stride, cin, seed):
    """The JAX and the port's layer on the same drawn params and BN state."""
    rng = np.random.default_rng(seed)
    itype = JInputType.convolutional(8, 8, cin)
    jlayer = JFusedBottleneck(filters=filters, stride=(stride, stride), project=True)
    params = {k: np.array(v, np.float32)
              for k, v in jlayer.init_params(jax.random.key(seed), itype).items()}
    for k in params:
        if k.startswith("gamma"):
            params[k] = rng.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
        elif k.startswith("beta"):
            params[k] = rng.normal(0, 0.2, params[k].shape).astype(np.float32)
    state = {k: (rng.normal(0, 0.2, np.asarray(v).shape[0]) if k.startswith("mean")
                 else rng.uniform(0.5, 1.5, np.asarray(v).shape[0])).astype(np.float32)
             for k, v in jlayer.init_state(itype).items()}
    x = rng.normal(size=(4, 8, 8, cin)).astype(np.float32)
    tlayer = FusedBottleneck(filters=filters, stride=(stride, stride), project=True)
    return jlayer, tlayer, params, state, x


BLOCKS = [((4, 4, 8), 1, 8), ((4, 4, 8), 2, 4), ((8, 8, 32), 1, 16), ((8, 8, 32), 2, 8)]


@pytest.mark.parametrize("filters,stride,cin", BLOCKS)
def test_ragged_fused_bottleneck_eval_matches_jax(filters, stride, cin):
    jlayer, tlayer, params, state, x = _block(filters, stride, cin, seed=40 + cin + stride)
    yj, _ = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()},
                         {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(x),
                         train=False)
    yt, _ = tlayer.apply({k: torch.from_numpy(v) for k, v in params.items()},
                         {k: torch.from_numpy(v) for k, v in state.items()},
                         torch.from_numpy(x), train=False)
    assert tuple(yt.shape) == tuple(yj.shape)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("filters,stride,cin", BLOCKS[:2])
def test_ragged_fused_bottleneck_train_matches_jax(filters, stride, cin):
    jlayer, tlayer, params, state, x = _block(filters, stride, cin, seed=50 + cin + stride)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}

    def jloss(p):
        out, new_state = jlayer.apply(p, jstate, jnp.asarray(x), train=True)
        return jnp.sum(out ** 2), (out, new_state)

    jgrads, (yj, sj) = jax.grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})
    tparams = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    yt, st = tlayer.apply(tparams, {k: torch.from_numpy(v) for k, v in state.items()},
                          torch.from_numpy(x), train=True)
    tgrads = torch.autograd.grad((yt ** 2).sum(), list(tparams.values()))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k, g in zip(tparams, tgrads):
        e = np.asarray(jgrads[k])
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-4 * np.abs(e).max(),
                                   err_msg=k)
