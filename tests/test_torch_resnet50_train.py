"""The port's ResNet-50 training slice held to the JAX package, in f32.

A 32x32, 10-class ResNet-50 (all 16 bottlenecks, full channel widths)
is initialised by the JAX package, with the residual branches' BN gammas
damped (x0.3) and the classifier scaled (x0.1) so that the loss starts
O(1), and trained there with ``Trainer.fit_batch`` under
``Nesterovs(0.003, 0.9)`` (at the default 0.1 the loss of such a small
batch diverges).  The reference is the JAX *unfused* graph: the fused
JAX kernel's backward cannot take res5's [1024, 2048] projection weight
in f32 (its TPU VMEM budget), and the JAX tests pin fused to unfused.
Weights move between the two lowerings with the JAX package's
``remap_bottleneck_params``.

Step 1 starts the port from the same weights; step 2 starts it from the
JAX run's params, BN state and optimizer state after step 1 (through
``interop.load_jax_opt_state``), which tests the momentum path.  Bands:
the loss at 1e-5 relative; BN running statistics at 1e-4 of each
tensor's largest entry; each param after the update within 0.1 of its
own update, in norm.  That last band is wide because f32 itself is: the
train-mode BN backward amplifies rounding block over block, so the same
port step in f32 and in f64 differs by 4.3% of the update's norm (median
over params; 5.5% at most) at 32x32, batch 16, and by 2.0% (2.9%) at
64x64, batch 8 (``test_f32_step_is_within_the_band_of_an_f64_step``);
port and JAX differ by at most 3%.  A wrong gradient moves whole tensors
by O(1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer
from deeplearning4j_tpu.train.updaters import Nesterovs as JNesterovs

from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.interop import load_jax_opt_state, load_jax_params
from deeplearning4j_tpu_torch.models import resnet50
from deeplearning4j_tpu_torch.nn.layers import fused as fused_mod
from deeplearning4j_tpu_torch.ops.kernels import conv_bn
from deeplearning4j_tpu_torch.train import Nesterovs, Trainer

LR, MOMENTUM, BATCH = 0.003, 0.9, 16
LOSS_RTOL, STATE_TOL, PARAM_TOL = 1e-5, 1e-4, 0.1


def np_tree(tree):
    return {v: {k: np.array(a) for k, a in d.items()} for v, d in tree.items()}


def jnp_tree(tree):
    return {v: {k: jnp.asarray(a) for k, a in d.items()} for v, d in tree.items()}


def start_weights(params):
    """Damp the residual branches' BN gammas and scale the classifier, in
    the unfused layout (``<block>_c_bn``, ``<block>_proj_bn``, ``out``)."""
    for v, d in params.items():
        if v.endswith(("_c_bn", "_proj_bn")):
            d["gamma"] = d["gamma"] * np.float32(0.3)
    params["out"]["W"] = params["out"]["W"] * np.float32(0.1)
    return params


def to_fused(params, state):
    return jzoo.remap_bottleneck_params(params, state, to_fused=True)


@pytest.fixture(scope="module")
def reference():
    jnet = jzoo.resnet50(height=32, width=32, num_classes=10, fused=False,
                         updater=JNesterovs(LR, MOMENTUM)).init()
    p0, s0 = start_weights(np_tree(jnet.params_)), np_tree(jnet.state_)
    jnet.params_ = jnp_tree(p0)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(BATCH, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, BATCH)]
    trainer = JTrainer(jnet)
    runs = [(p0, s0, None)]
    losses = []
    for step in range(2):
        losses.append(float(trainer.fit_batch(JDataSet(x, y), jax.random.key(step))))
        trace = jnet.opt_state[1][0].trace
        runs.append((np_tree(jnet.params_), np_tree(jnet.state_), np_tree(trace)))
    return {"x": x, "y": y, "runs": runs, "losses": losses}


def _port_net(params, state, trace=None):
    net = resnet50(height=32, width=32, num_classes=10, fused=True, device="cpu",
                   updater=Nesterovs(LR, MOMENTUM))
    fp, fs = to_fused(params, state)
    load_jax_params(net, fp, fs)
    if trace is not None:
        ftrace, _ = to_fused(trace, state)
        load_jax_opt_state(net, (optax.EmptyState(), (optax.TraceState(trace=ftrace),
                                                      optax.EmptyState())))
    return net


def _assert_step_matches(net, loss, reference, step):
    want_p, want_s, _ = to_fused(*reference["runs"][step + 1][:2]) + (None,)
    before, _ = to_fused(*reference["runs"][step][:2])
    assert loss.ndim == 0 and loss.device.type == "cpu"
    np.testing.assert_allclose(loss.item(), reference["losses"][step], rtol=LOSS_RTOL)
    for v, d in want_s.items():
        for k, e in d.items():
            g = net.state_[v][k].numpy()
            np.testing.assert_allclose(g, e, rtol=0, atol=STATE_TOL * np.abs(e).max(),
                                       err_msg=f"state {v}.{k}")
    for v, d in want_p.items():
        for k, e in d.items():
            update = np.linalg.norm(e - before[v][k])
            assert update > 0, f"{v}.{k} did not move"
            err = np.linalg.norm(net.params_[v][k].numpy() - e) / update
            assert err <= PARAM_TOL, f"param {v}.{k}: {err:.3g} of its update"


def test_fit_batch_step1_matches_jax(reference):
    p0, s0, _ = reference["runs"][0]
    net = _port_net(p0, s0)
    loss = Trainer(net).fit_batch(DataSet(reference["x"], reference["y"]))
    assert net.opt_state is not None and set(net.opt_state) == {"trace"}
    _assert_step_matches(net, loss, reference, 0)


def test_fit_batch_step2_from_jax_optimizer_state_matches_jax(reference):
    p1, s1, trace1 = reference["runs"][1]
    net = _port_net(p1, s1, trace1)
    loss = Trainer(net).fit_batch(DataSet(reference["x"], reference["y"]),
                                  torch.Generator().manual_seed(1))
    _assert_step_matches(net, loss, reference, 1)


def test_load_jax_opt_state_rejects_a_state_without_the_trace(reference):
    p0, s0, _ = reference["runs"][0]
    net = _port_net(p0, s0)
    with pytest.raises(KeyError, match="trace"):
        load_jax_opt_state(net, (optax.EmptyState(), optax.EmptyState()))


def test_graph_fit_moves_the_loss(reference):
    """``ComputationGraph.fit`` over an ``ArrayDataSetIterator``: two steps
    per epoch, one kernel-path forward and backward per bottleneck conv
    (the plain pair on the CPU), and the inference loss on the data
    drops."""
    p0, s0, _ = reference["runs"][0]
    net = _port_net(p0, s0)
    x = np.concatenate([reference["x"]] * 2)
    y = np.concatenate([reference["y"]] * 2)
    data = DataSet(x, y)
    before = Trainer(net).eval_loss(data).item()
    launches = (conv_bn.launches, conv_bn.bwd_launches)
    net.fit(ArrayDataSetIterator(x, y, batch_size=BATCH, shuffle=True, seed=3), epochs=1)
    assert (conv_bn.launches, conv_bn.bwd_launches) == launches   # CPU: no kernel
    assert net.iteration == 2 and net.epoch == 1
    assert np.isfinite(net.score())
    after = Trainer(net).eval_loss(data).item()
    assert after < before


def _pad_rows(t, pad):
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def _drop_ds2(x, w, a, b, y, dy, ds1, ds2, *, relu_in=True):
    return conv_bn.matmul_bn_act_bwd_plain(x, w, a, b, y, dy, ds1, torch.zeros_like(ds2),
                                           relu_in=relu_in)


def _da_over_xhat(x, w, a, b, y, dy, ds1, ds2, *, relu_in=True):
    dx, dw, da, db = conv_bn.matmul_bn_act_bwd_plain(x, w, a, b, y, dy, ds1, ds2,
                                                     relu_in=relu_in)
    if a is not None:
        dyt = dy + ds1 + 2.0 * y * ds2
        pre = x * a + b
        xh = torch.relu(pre) if relu_in else pre
        dpre = dyt @ w.t()
        if relu_in:
            dpre = torch.where(pre > 0, dpre, 0.0)
        da = (dpre * xh).sum(0)
    return dx, dw, da, db


def _padded_rows_in_dw(x, w, a, b, y, dy, ds1, ds2, *, relu_in=True):
    """dW summed over the last 128-row tile's padding too (those rows
    carry dyt = ds1 and, with a prologue, xhat = act(b))."""
    dx, _, da, db = conv_bn.matmul_bn_act_bwd_plain(x, w, a, b, y, dy, ds1, ds2,
                                                    relu_in=relu_in)
    pad = -x.shape[0] % 128
    _, dw, _, _ = conv_bn.matmul_bn_act_bwd_plain(
        _pad_rows(x, pad), w, a, b, _pad_rows(y, pad), _pad_rows(dy, pad), ds1, ds2,
        relu_in=relu_in)
    return dx, dw, da, db


SMOKE_CLASSES = 10


def _smoke_net():
    import chip_smoke
    n = resnet50(height=32, width=32, num_classes=SMOKE_CLASSES, fused=True, device="cpu",
                 updater=Nesterovs(chip_smoke.TRAIN_LR, 0.9))
    return chip_smoke.damp_residual_gammas(n.init(seed=chip_smoke.SEED))


@pytest.fixture(scope="module")
def smoke_runs():
    """The step that every fault case is held to, through the plain pair,
    and the clean step through the layer's own path (the plain pair on the
    CPU), run once for the module."""
    import chip_smoke
    rng = np.random.default_rng(4)
    batch = DataSet(rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                    np.eye(SMOKE_CLASSES, dtype=np.float32)[rng.integers(0, SMOKE_CLASSES, 4)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_mod, "matmul_bn_act", chip_smoke._PlainMatmulBnAct())
        plain = chip_smoke.train_steps(_smoke_net(), batch, 1)
    clean = chip_smoke.train_steps(_smoke_net(), batch, 1)
    return {"batch": batch, "plain": plain, "clean": clean}


@pytest.mark.parametrize("fault", [_drop_ds2, _da_over_xhat, _padded_rows_in_dw],
                         ids=["ds2_term_dropped", "da_over_xhat", "padded_rows_in_dw"])
def test_smoke_training_check_catches_backward_wiring_faults(fault, monkeypatch, smoke_runs):
    """chip_smoke.py holds each param's step-0 update through the kernels
    to the one through the plain versions at TRAIN_UPDATE_TOL (relative,
    in norm).  A fault in the backward's wiring moves that reading by far
    more than the limit; without one, on the CPU (where the kernel path
    runs the plain pair) it reads 0.  The net has a 10-class head: the
    faults are in the bottlenecks' 1x1 convs, and each reads as far past
    the limit as with chip_smoke.py's 1000 classes (at least 1800x, where
    1000 classes read at least 3000x)."""
    import chip_smoke
    plain = smoke_runs["plain"]
    errs = chip_smoke.update_errs(smoke_runs["clean"]["update0"], plain["update0"])
    assert max(errs.values()) == 0.0
    monkeypatch.setattr(conv_bn, "matmul_bn_act_bwd", fault)
    faulty = chip_smoke.train_steps(_smoke_net(), smoke_runs["batch"], 1)
    errs = chip_smoke.update_errs(faulty["update0"], plain["update0"])
    assert max(errs.values()) > 100 * chip_smoke.TRAIN_UPDATE_TOL


@pytest.mark.parametrize("size,batch", [(32, 16), (64, 8)])
def test_f32_step_is_within_the_band_of_an_f64_step(size, batch):
    """The f32 band above is f32's own: the same port step in f64 (the
    fused layer's exact branch) lands every param within PARAM_TOL of the
    f32 step's update, in norm, and the median param within 5%."""
    from deeplearning4j_tpu_torch import config as tconfig

    rng = np.random.default_rng(size)
    x = rng.normal(size=(batch, size, size, 3))
    y = np.eye(10)[rng.integers(0, 10, batch)]
    start = resnet50(height=size, width=size, num_classes=10, device="cpu").init(seed=5)
    for d in start.params_.values():
        for k in ("gamma_c", "gamma_proj"):
            if k in d:
                d[k].mul_(0.3)
    start.params_["out"]["W"].mul_(0.1)

    def step(dtype):
        tdtype = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
        tconfig.set_dtype_policy(tconfig.DTypePolicy(tdtype, tdtype, tdtype))
        try:
            net = resnet50(height=size, width=size, num_classes=10, device="cpu",
                           updater=Nesterovs(LR, MOMENTUM))
            # copies: the step updates the net's tensors in place
            net.params_, net.state_ = ({v: {k: t.to(tdtype, copy=True) for k, t in d.items()}
                                        for v, d in tree.items()}
                                       for tree in (start.params_, start.state_))
            Trainer(net).fit_batch(DataSet(x.astype(dtype), y.astype(dtype)))
        finally:
            tconfig.set_dtype_policy(tconfig.DTypePolicy.f32())
        return net.params_

    p64, p32 = step(np.float64), step(np.float32)
    errs = []
    for v, d in p64.items():
        for k, e in d.items():
            update = (e - start.params_[v][k].double()).norm()
            errs.append(((p32[v][k].double() - e).norm() / update).item())
    assert max(errs) <= PARAM_TOL
    assert 0 < np.median(errs) <= 0.05, sorted(errs)[len(errs) // 2]
