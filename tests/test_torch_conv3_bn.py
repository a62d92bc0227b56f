"""The port's fused 3x3 conv + BN statistics (``conv3x3_bn_act``) held to
the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernel in interpret mode on the CPU, whose whole-plane body is the
only one interpret mode takes) and through the port's plain PyTorch
version, which the port's wrapper runs for CPU tensors.  Cases: the
reference test's (2, 8, 7, 16) case, C != Cout, and a ResNet-50 stage at
batch 1 (14 x 14 x 64), each with the prologue (``relu_in`` on and off)
and without it (``relu_in`` on, which must then do nothing).

Bands.  f32: y at 1e-5, s1 and s2 at 1e-4 relative (``TestConv3BnFused``'s
bands), with an absolute floor of 1e-4 of the column's sum of |y| (resp.
of max s2), since a channel's sum of y can cancel to near zero; both
sides compute in f32 in other orders.  bf16: y to 8e-3 of max |y| (one
bf16 rounding, 2^-8, where the two f32 sums round to either side), s1
and s2 as in f32: both are sums of the f32 accumulator.  The port's
``conv3x3_reference`` is the twin of the JAX ``_reference``, whose
statistics are sums of the rounded y: held at the same bands.

Shapes the reference refuses: a plane over 1 MB with H % 8 != 0 raises
in the JAX function on every backend; the port takes it, held to the JAX
``_reference``.  A plane over 1 MB with H % 8 == 0 is where the TPU runs
the row-tiled body; in interpret mode it runs the whole-plane body, and
the port is held to both that and ``_reference``.

Gradients: the reference test's loss ``y.sum() + (s1*s1).sum() +
s2.sum()`` through the port's op (autograd of ``conv3x3_reference``) and
``jax.grad`` through the JAX op (the vjp of its XLA reference), at
rtol 1e-4, atol 1e-5 (the reference test's); without a prologue the
input goes in unclipped and some of dW's sums cancel to 1e-3 of its
largest entry (~100), so atol there is 1e-6 of each gradient's largest
entry.  A FusedBottleneck carried
across with ``load_jax_params``: its train-mode output and the 3x3
stage's running statistics against the JAX layer's at 1e-5, and the 3x3
stage's own inputs, watched through ``conv3x3_stage``, through the port's
op against the stage's outputs and against the JAX layer's conv.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import FusedBottleneck as JFusedBottleneck

from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import FusedBottleneck
from deeplearning4j_tpu_torch.nn.layers import fused
from deeplearning4j_tpu_torch.ops.kernels import conv3_bn

cb = importlib.import_module("deeplearning4j_tpu.ops.pallas.conv3_bn")

# name: (N, H, W, C, Cout)
CASES = {
    "reference": (2, 8, 7, 16, 16),
    "c_ne_cout": (2, 6, 5, 24, 40),
    "resnet_stage": (1, 14, 14, 64, 64),
}
# (prologue, relu_in)
VARIANTS = [(True, True), (True, False), (False, True)]
Y_TOL = {"f32": 1e-5, "bf16": 8e-3}
S_RTOL = 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, h, w, c, cout, seed=0):
    """x, w, a, b as float32 numpy arrays, the reference test's scales."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, h, w, c)).astype(np.float32),
            rng.normal(0, 0.1, (3, 3, c, cout)).astype(np.float32),
            rng.normal(1, 0.1, c).astype(np.float32),
            rng.normal(0, 0.1, c).astype(np.float32))


def _rounded(arrays, dtype):
    """Each array rounded once to the working type (numpy f32 values)."""
    jd = DTYPES[dtype][0]
    return [np.array(jnp.asarray(t, jd).astype(jnp.float32)) for t in arrays]


def _torch_args(x, w, a, b, dtype, prologue):
    td = DTYPES[dtype][1]
    return (torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
            torch.from_numpy(a) if prologue else None, torch.from_numpy(b) if prologue else None)


def _jax_args(x, w, a, b, dtype, prologue):
    jd = DTYPES[dtype][0]
    return (jnp.asarray(x, jd), jnp.asarray(w, jd),
            jnp.asarray(a) if prologue else None, jnp.asarray(b) if prologue else None)


def _assert_close(got, want, y_tol, what=""):
    """(y, s1, s2) against (y, s1, s2): y over max |y|; s1, s2 at S_RTOL
    relative with an absolute floor of S_RTOL of their scale."""
    (y, s1, s2), (ye, s1e, s2e) = [[np.asarray(t, np.float64) for t in ts] for ts in (got, want)]
    assert y.shape == ye.shape, what
    err = np.abs(y - ye).max() / max(np.abs(ye).max(), 1e-30)
    assert err <= y_tol, f"{what} y: {err:.2e} over {y_tol}"
    s1_scale = np.abs(ye).sum(axis=(0, 1, 2)).max()
    np.testing.assert_allclose(s1, s1e, rtol=S_RTOL, atol=S_RTOL * s1_scale, err_msg=f"{what} s1")
    np.testing.assert_allclose(s2, s2e, rtol=S_RTOL, atol=S_RTOL * np.abs(s2e).max(),
                               err_msg=f"{what} s2")


def _numpy(outs):
    return [np.asarray(t.float().detach().numpy() if torch.is_tensor(t) else
                       jnp.asarray(t, jnp.float32)) for t in outs]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("prologue,relu_in", VARIANTS)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_kernel(case, prologue, relu_in, dtype):
    x, w, a, b = _inputs(*CASES[case], seed=len(case))
    x, w = _rounded((x, w), dtype)
    want = cb.conv3x3_bn_act(*_jax_args(x, w, a, b, dtype, prologue), relu_in=relu_in,
                             interpret=True)
    got = conv3_bn.conv3x3_bn_act_plain(*_torch_args(x, w, a, b, dtype, prologue),
                                        relu_in=relu_in)
    assert got[0].dtype == DTYPES[dtype][1] and got[1].dtype == got[2].dtype == torch.float32
    _assert_close(_numpy(got), _numpy(want), Y_TOL[dtype], f"{case} {dtype}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("prologue,relu_in", VARIANTS)
def test_conv3x3_reference_matches_jax_reference(prologue, relu_in, dtype):
    x, w, a, b = _inputs(*CASES["c_ne_cout"], seed=5)
    x, w = _rounded((x, w), dtype)
    jx, jw, _, _ = _jax_args(x, w, a, b, dtype, True)
    want = cb._reference(jx, jw, jnp.asarray(a), jnp.asarray(b), has_prologue=prologue,
                         relu_in=relu_in)
    tx, tw, ta, tb = _torch_args(x, w, a, b, dtype, True)
    got = conv3_bn.conv3x3_reference(tx, tw, ta, tb, has_prologue=prologue, relu_in=relu_in)
    assert got[0].dtype == DTYPES[dtype][1]
    _assert_close(_numpy(got), _numpy(want), Y_TOL[dtype], dtype)


def test_the_statistics_rules_differ_by_one_rounding_in_bf16():
    """The kernel's s1, s2 sum the f32 accumulator; the reference's sum the
    rounded y.  In f32 the two are one function; in bf16 they part, and
    the plain version follows the kernel."""
    x, w, a, b = _rounded(_inputs(*CASES["resnet_stage"], seed=9), "bf16")
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    y, s1, s2 = conv3_bn.conv3x3_bn_act_plain(tx, tw, ta, tb)
    yr, s1r, s2r = conv3_bn.conv3x3_reference(tx, tw, ta, tb, has_prologue=True, relu_in=True)
    yf = y.float()
    torch.testing.assert_close(yr.float().sum((0, 1, 2)), s1r)
    assert not torch.equal(s1, yf.sum((0, 1, 2)))   # not the sum of the rounded y
    assert (s1 - s1r).abs().max() <= 1e-2 * yf.abs().sum((0, 1, 2)).max()


@pytest.mark.parametrize("h,w,refused", [(113, 97, True), (112, 96, False)])
def test_planes_over_1mb_are_held_to_the_reference(h, w, refused):
    """H % 8 != 0: the JAX function refuses the plane and the port takes
    it.  H % 8 == 0: the TPU's row-tiled body's shape, run here (interpret
    mode) through the whole-plane body."""
    x, wt, a, b = _inputs(1, h, w, 32, 16, seed=h)
    assert h * w * 32 * 4 > 2 ** 20 and bool(h % 8) == refused
    jargs = _jax_args(x, wt, a, b, "f32", True)
    ref = cb._reference(*jargs, has_prologue=True, relu_in=True)
    got = conv3_bn.conv3x3_bn_act(*_torch_args(x, wt, a, b, "f32", True), relu_in=True)
    _assert_close(_numpy(got), _numpy(ref), Y_TOL["f32"], "vs _reference")
    if refused:
        with pytest.raises(ValueError, match="H divisible by 8"):
            cb.conv3x3_bn_act(*jargs, relu_in=True, interpret=True)
    else:
        kernel = cb.conv3x3_bn_act(*jargs, relu_in=True, interpret=True)
        _assert_close(_numpy(got), _numpy(kernel), Y_TOL["f32"], "vs the kernel")


def test_without_a_prologue_relu_in_clips_nothing():
    x, w, _, _ = _inputs(*CASES["reference"], seed=3)
    assert (x < 0).any()
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for relu_in in (True, False):
        got = conv3_bn.conv3x3_bn_act(tx, tw, relu_in=relu_in)
        want = conv3_bn.conv3x3_bn_act_plain(tx, tw)
        for g, e in zip(got, want):
            torch.testing.assert_close(g, e, rtol=0, atol=0)


@pytest.mark.parametrize("prologue", [True, False])
def test_gradients_match_jax_grad(prologue):
    """The reference test's loss through each op: x, w, a and b (x and w
    without a prologue, where a and b take no part)."""
    x, w, a, b = _inputs(*CASES["reference"])
    jprims = [jnp.asarray(t) for t in ((x, w, a, b) if prologue else (x, w))]

    def jloss(*p):
        y, s1, s2 = cb.conv3x3_bn_act(*p, interpret=True)
        return y.sum() + (s1 * s1).sum() + s2.sum()

    jgrads = jax.grad(jloss, argnums=tuple(range(len(jprims))))(*jprims)
    tprims = [torch.from_numpy(t).requires_grad_(True)
              for t in ((x, w, a, b) if prologue else (x, w))]
    before = conv3_bn.launches
    y, s1, s2 = conv3_bn.conv3x3_bn_act(*tprims)
    tgrads = torch.autograd.grad(y.sum() + (s1 * s1).sum() + s2.sum(), tprims)
    assert conv3_bn.launches == before
    for name, g, e in zip("xwab", tgrads, jgrads):
        e = np.asarray(e)
        atol = 1e-5 if prologue else 1e-6 * np.abs(e).max()
        np.testing.assert_allclose(g.numpy(), e, rtol=1e-4, atol=atol, err_msg=name)


def _graphs(filters, cin, seed):
    """A one-bottleneck graph in each package; the port's carries the JAX
    one's params (gammas, betas and running statistics drawn from a seed)
    through ``load_jax_params``."""
    rng = np.random.default_rng(seed)
    jgb = (JConf.builder().seed(seed).weight_init("relu").graph().add_inputs("in")
           .set_input_types(JInputType.convolutional(8, 8, cin)))
    jgb.add_layer("b", JFusedBottleneck(filters=filters, project=True), "in")
    jgb.set_outputs("b")
    jnet = JGraph(jgb.build()).init()
    params = {v: {k: np.array(t, np.float32) for k, t in d.items()}
              for v, d in jnet.params_.items()}
    state = {v: {k: np.array(t, np.float32) for k, t in d.items()}
             for v, d in jnet.state_.items()}
    for k in params["b"]:
        if k.startswith("gamma"):
            params["b"][k] = rng.uniform(0.5, 1.5, params["b"][k].shape).astype(np.float32)
        elif k.startswith("beta"):
            params["b"][k] = rng.normal(0, 0.2, params["b"][k].shape).astype(np.float32)
    for k in state["b"]:
        n = state["b"][k].shape[0]
        state["b"][k] = (rng.normal(0, 0.2, n) if k.startswith("mean")
                         else rng.uniform(0.5, 1.5, n)).astype(np.float32)
    gb = (NeuralNetConfiguration.builder().seed(seed).weight_init("relu").graph().add_inputs("in")
          .set_input_types(InputType.convolutional(8, 8, cin)))
    gb.add_layer("b", FusedBottleneck(filters=filters, project=True), "in")
    gb.set_outputs("b")
    net = load_jax_params(ComputationGraph(gb.build(), device="cpu"), params, state)
    x = rng.normal(size=(4, 8, 8, cin)).astype(np.float32)
    return jnet, net, params, state, x


def test_bottleneck_3x3_stage_matches_jax_and_the_op(monkeypatch):
    filters = (16, 24, 32)
    jnet, net, params, state, x = _graphs(filters, cin=16, seed=4)
    yj, sj = JFusedBottleneck(filters=filters, project=True).apply(
        {k: jnp.asarray(v) for k, v in params["b"].items()},
        {k: jnp.asarray(v) for k, v in state["b"].items()}, jnp.asarray(x), train=True)

    seen = []
    stage = fused.conv3x3_stage

    def watch(y1, a1, b1, w, shape, *, train):
        out = stage(y1, a1, b1, w, shape, train=train)
        seen.append(((y1, a1, b1, w, shape), out))
        return out

    monkeypatch.setattr(fused, "conv3x3_stage", watch)
    yt, st, _ = net._forward(net.params_, net.state_, torch.from_numpy(x), train=True)
    assert len(seen) == 1
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    for key in ("mean_b3", "var_b3"):
        np.testing.assert_allclose(st["b"][key].numpy(), np.asarray(sj[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)

    (y1, a1, b1, w, (n, h, wd)), (y2, s1, s2) = seen[0]
    assert tuple(w.shape) == (3, 3, filters[0], filters[1])
    x4 = y1.reshape(n, h, wd, filters[0])
    # the JAX layer's own 3x3 (fused.py: normalize pass, XLA conv, sums)
    # on the same inputs
    z1 = jnp.maximum(jnp.asarray(y1.numpy()) * jnp.asarray(a1.numpy())
                     + jnp.asarray(b1.numpy()), 0).reshape(n, h, wd, filters[0])
    yj2 = jax.lax.conv_general_dilated(z1, jnp.asarray(w.numpy()), (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    stage_out = (y2.reshape(n, h, wd, filters[1]), s1, s2)
    _assert_close(_numpy(stage_out), _numpy((yj2, yj2.sum((0, 1, 2)),
                                             (yj2 * yj2).sum((0, 1, 2)))), 1e-5, "vs JAX")
    # the op computes the stage's function
    got = conv3_bn.conv3x3_bn_act(x4, w, a1, b1, relu_in=True)
    _assert_close(_numpy(got), _numpy(stage_out), 1e-5, "op vs stage")
