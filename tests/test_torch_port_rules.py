"""Rules the PyTorch port keeps: it imports nothing of JAX or of the JAX
package, its entry points default to the CUDA card and raise without one,
a CPU run (serving or training) never reaches the kernel loader, the
wrappers refuse what their kernels do not take, and a failed kernel
launch raises and is not counted."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.models import resnet50, vgg16
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.models import BertConfig, BertForMaskedLM
from deeplearning4j_tpu_torch.nn.quantize import quantize_net
from deeplearning4j_tpu_torch.ops.kernels import _build, conv_bn, flash_attention, quant_matmul
from deeplearning4j_tpu_torch.serve import InferenceEngine
from deeplearning4j_tpu_torch.train import Trainer

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(Path(deeplearning4j_tpu_torch.__file__).parent.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    assert path.exists()
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_no_jax_scan_covers_the_int8_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("nn/conf.py", "nn/multilayer.py", "nn/quantize.py", "models/zoo.py",
                   "ops/kernels/quant_matmul.py", "interop.py", "serve/engine.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names


def test_profile_counts_every_kernel_of_the_port_in_its_own_category():
    """chip_profile.py files each CUDA kernel of csrc/ under a named
    category, never under "other" or a library category."""
    import re
    import chip_profile
    ours = {"int8_matmul", "matmul_bn_act", "matmul_bn_act_bwd", "flash_attention",
            "flash_attention_bwd"}
    for src in sorted(_build.CSRC.glob("*.cu")):
        names = re.findall(r"__global__.*?\b(\w+_kernel)\(", src.read_text(), re.S)
        assert names, src.name
        for name in names:
            assert chip_profile.category(name) in ours, (src.name, name)


def test_port_reads_no_dl4j_tpu_environment_variable():
    for path in PORT_FILES:
        assert "DL4J_TPU_" not in path.read_text(), path


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card_and_raise_without_one(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet50(height=32, width=32, num_classes=10)
    net = resnet50(height=32, width=32, num_classes=10, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(net.conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        net.init(device="cuda")
    net.device = torch.device("cuda")   # a net made where a card was
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(net)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(net)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vgg16()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(vgg16(device="cpu").conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertForMaskedLM(BertConfig.tiny())


def test_cpu_run_never_touches_the_kernel_loader(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("kernel loader reached on a CPU run")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    before = conv_bn.launches
    net = resnet50(height=32, width=32, num_classes=10, device="cpu").init(seed=3)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = net.output(x)
    assert tuple(y.shape) == (2, 10) and torch.isfinite(y).all()
    with InferenceEngine(net, max_batch=4) as engine:
        assert engine.predict(x, timeout_s=60).shape == (2, 10)
    bwd_before = conv_bn.bwd_launches
    loss = Trainer(net).fit_batch(DataSet(x, np.eye(10, dtype=np.float32)[[1, 2]]))
    assert loss.ndim == 0 and torch.isfinite(loss)
    assert conv_bn.launches == before and conv_bn.bwd_launches == bwd_before


def test_cpu_bert_run_never_touches_the_kernel_loader(monkeypatch):
    """BERT at the flash routing length serves and takes a training step
    on the CPU through the plain versions: no build, no launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("kernel loader reached on a CPU run")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    cfg = BertConfig(vocab_size=50, hidden_size=16, num_layers=1, num_heads=2,
                     intermediate_size=32, max_position=1024)
    model = BertForMaskedLM(cfg, device="cpu")
    ids = np.random.default_rng(0).integers(0, 50, (1, 1024))
    before = (flash_attention.launches, flash_attention.bwd_launches)
    assert tuple(model.predict_mlm(ids).shape) == (1, 1024, 50)
    loss = model.fit([{"input_ids": ids, "labels": ids,
                       "label_weights": np.ones((1, 1024), np.float32)}])
    assert np.isfinite(loss)
    assert (flash_attention.launches, flash_attention.bwd_launches) == before


class _StubLib:
    """Stands in for the built library: reports a tile size and returns
    ``rc`` from the launch, as cudaGetLastError() would."""

    def __init__(self, rc):
        self.rc = rc
        self.calls = 0

    def matmul_bn_act_tile_m(self):
        return 128

    def matmul_bn_act_f32(self, *args):
        self.calls += 1
        assert len(args) == 15 and args[-1] == 0   # pointers, sizes, flags, stream
        return self.rc


def test_failed_launch_raises_and_is_not_counted():
    x, w = torch.zeros(4, 32), torch.zeros(32, 32)
    before = conv_bn.launches
    lib = _StubLib(rc=9)   # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="cudaGetLastError"):
        conv_bn._launch(lib, x, w, None, None, True, 0)
    assert lib.calls == 1 and conv_bn.launches == before
    conv_bn._launch(_StubLib(rc=0), x, w, None, None, True, 0)
    assert conv_bn.launches == before + 1
    conv_bn.launches = before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    meta = torch.empty(4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_bn.matmul_bn_act(meta, torch.empty(32, 32, device="meta"))
    with pytest.raises(ValueError, match="both a and b"):
        conv_bn.matmul_bn_act(torch.zeros(4, 32), torch.zeros(32, 32), torch.ones(32), None)


class _StubBwdLib:
    """The built backward library: a tile size, and ``rc`` from the launch."""

    def __init__(self, rc):
        self.rc = rc
        self.args = None

    def matmul_bn_act_bwd_tile(self):
        return 128

    def matmul_bn_act_bwd_f32(self, *args):
        self.args = args
        return self.rc


@pytest.mark.parametrize("prologue", [False, True])
def test_failed_backward_launch_raises_and_is_not_counted(prologue):
    m, k, n = 300, 64, 96
    x, w, y, dy = torch.zeros(m, k), torch.zeros(k, n), torch.zeros(m, n), torch.zeros(m, n)
    a, b = (torch.ones(k), torch.zeros(k)) if prologue else (None, None)
    ds = torch.zeros(n)
    before = conv_bn.bwd_launches
    lib = _StubBwdLib(rc=2)   # cudaErrorMemoryAllocation
    with pytest.raises(RuntimeError, match="cudaGetLastError"):
        conv_bn._launch_bwd(lib, x, w, a, b, y, dy, ds, ds, True, 0, 114)
    assert conv_bn.bwd_launches == before
    # pointers, then M, N, K, splits, rows per split, prologue, relu_in, stream
    assert len(lib.args) == 23 and lib.args[15:18] == (m, n, k)
    splits, chunk = lib.args[18:20]
    assert (splits, chunk) == conv_bn.dw_splits(m, k, n, 128, 114)
    assert (lib.args[11] is None) == (not prologue)       # db only with a prologue
    dx, dw, da, db = conv_bn._launch_bwd(_StubBwdLib(rc=0), x, w, a, b, y, dy, ds, ds, True,
                                        0, 114)
    assert conv_bn.bwd_launches == before + 1
    assert tuple(dx.shape) == (m, k) and tuple(dw.shape) == (k, n)
    assert (da is None) == (not prologue) and (db is None) == (not prologue)
    conv_bn.bwd_launches = before


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad,error,match", [
    ({"x": _meta(64, 32, dtype=torch.float16), "w": _meta(32, 64, dtype=torch.float16),
      "y": _meta(64, 64, dtype=torch.float16), "dy": _meta(64, 64, dtype=torch.float16)},
     TypeError, "float32 or bfloat16"),
    ({"dy": _meta(64, 48)}, ValueError, "dy must be"),
    ({"y": _meta(64, 64, dtype=torch.bfloat16)}, ValueError, "y must be"),
    ({"ds2": _meta(64, dtype=torch.float64)}, ValueError, "ds2 must be"),
    ({"w": _meta(32, 48), "dy": _meta(64, 48), "y": _meta(64, 48),
      "ds1": _meta(48), "ds2": _meta(48)}, ValueError, "multiples of 32"),
    ({"a": _meta(16)}, ValueError, "a must be"),
    ({}, ValueError, "unsupported device"),
])
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(bad, error, match):
    args = {"x": _meta(64, 32), "w": _meta(32, 64), "a": _meta(32), "b": _meta(32),
            "y": _meta(64, 64), "dy": _meta(64, 64), "ds1": _meta(64), "ds2": _meta(64)}
    args.update(bad)
    with pytest.raises(error, match=match):
        conv_bn.matmul_bn_act_bwd(**args, relu_in=True)


def test_backward_wrapper_makes_cotangents_contiguous(monkeypatch):
    """Autograd may hand the backward an expanded (stride-0) dy; the
    wrapper copies it before any check or pointer is taken."""
    seen = {}

    def spy(x, w, a, b, y, dy, ds1, ds2):
        seen.update(dy=dy.is_contiguous(), ds1=ds1.is_contiguous())
        raise RuntimeError("stop")

    monkeypatch.setattr(conv_bn, "_check_bwd", spy)
    dy = _meta(1, 64).expand(64, 64)
    ds1 = _meta(1).expand(64)
    assert not dy.is_contiguous()
    with pytest.raises(RuntimeError, match="stop"):
        conv_bn.matmul_bn_act_bwd(_meta(64, 32), _meta(32, 64), None, None, _meta(64, 64),
                                  dy, ds1, _meta(64), relu_in=True)
    assert seen == {"dy": True, "ds1": True}


@pytest.mark.parametrize("bad,error,match", [
    ({"q": torch.zeros(1, 2, 8, 64, dtype=torch.float16)}, TypeError, "float32 or bfloat16"),
    ({"q": torch.zeros(1, 2, 8, 32), "k": torch.zeros(1, 2, 8, 32)}, ValueError,
     r"head dim \(64,\)"),
    ({"k": torch.zeros(1, 3, 8, 64)}, ValueError, r"not \[B,H,Tq,D\]"),
    ({"k": torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)}, TypeError, "k must match"),
    ({"mask": torch.ones(1, 9)}, ValueError, "key_mask must be"),
    ({"q": torch.zeros(1, 2, 64, 8).transpose(2, 3)}, ValueError, "contiguous"),
    ({}, ValueError, "unsupported device"),
])
def test_flash_check_refuses_what_the_kernels_do_not_take(bad, error, match):
    args = {"q": torch.zeros(1, 2, 8, 64), "k": torch.zeros(1, 2, 8, 64),
            "mask": torch.ones(1, 8)}
    args.update(bad)
    with pytest.raises(error, match=match):
        flash_attention._check(args["q"], args["k"], torch.zeros_like(args["k"]), args["mask"],
                               "flash_attention")


class _StubFlashLib:
    """The built library: returns ``rc`` from the launch."""

    def __init__(self, rc):
        self.rc = rc
        self.args = None

    def _call(self, *args):
        self.args = args
        return self.rc

    flash_attention_fwd_f32 = flash_attention_bwd_f32 = _call


def test_failed_flash_launches_raise_and_are_not_counted():
    q, k = torch.zeros(2, 3, 70, 64), torch.zeros(2, 3, 130, 64)
    mask = torch.ones(2, 130)
    before = (flash_attention.launches, flash_attention.bwd_launches)
    lib = _StubFlashLib(rc=9)   # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="cudaGetLastError"):
        flash_attention._launch_fwd(lib, q, k, k, mask, 0.125, False, 0, 0, False, 0)
    # pointers, then bh, heads, tq, tk, q_offset, k_offset, causal, normalize; scale; stream
    assert len(lib.args) == 19 and lib.args[9:17] == (6, 3, 70, 130, 0, 0, 0, 0)
    lse = torch.zeros(2, 3, 70)
    with pytest.raises(RuntimeError, match="cudaGetLastError"):
        flash_attention._launch_bwd(lib, q, k, k, None, q, lse, lse, 0.125, True, 5, 0, 0)
    assert len(lib.args) == 20 and lib.args[3] is None
    assert lib.args[11:18] == (6, 3, 70, 130, 5, 0, 1)
    assert (flash_attention.launches, flash_attention.bwd_launches) == before
    out, lse = flash_attention._launch_fwd(_StubFlashLib(rc=0), q, k, k, mask, 0.125, False, 0, 0,
                                           True, 0)
    assert out.shape == q.shape and out.dtype == q.dtype and lse.shape == (2, 3, 70)
    dq, dk, dv = flash_attention._launch_bwd(_StubFlashLib(rc=0), q, k, k, mask, q, lse, lse,
                                             0.125, False, 0, 0, 0)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert (flash_attention.launches, flash_attention.bwd_launches) == (before[0] + 1,
                                                                        before[1] + 1)
    flash_attention.launches, flash_attention.bwd_launches = before


def _tiny_vgg(device="cpu"):
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer, OutputLayer,
                                                    SubsamplingLayer)
    conf = (NeuralNetConfiguration.builder().seed(1).weight_init("relu").list()
            .layer(ConvolutionLayer(n_out=8, kernel_size=(3, 3), convolution_mode="same",
                                    activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 3)).build())
    return MultiLayerNetwork(conf, device=device)


def test_cpu_int8_run_never_touches_the_kernel_loader(monkeypatch):
    """A quantized net serves on the CPU, directly and through the engine,
    through int8_matmul_plain: no build, no launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("kernel loader reached on a CPU run")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    x = np.random.default_rng(0).normal(size=(3, 8, 8, 3)).astype(np.float32)
    qnet = quantize_net(_tiny_vgg().init(seed=2), calibration=[x])
    before = quant_matmul.launches
    y = qnet.output(x)
    assert tuple(y.shape) == (3, 10) and torch.isfinite(y).all()
    with InferenceEngine(qnet, max_batch=4) as engine:
        assert engine.precision == "int8"
        assert engine.predict(x, timeout_s=60).shape == (3, 10)
    assert quant_matmul.launches == before


class _StubInt8Lib:
    """The built library: returns ``rc`` from the launch."""

    def __init__(self, rc):
        self.rc = rc
        self.args = None

    def int8_matmul_f32(self, *args):
        self.args = args
        return self.rc


def test_failed_int8_launch_raises_and_is_not_counted():
    m, k, n = 7, 4096, 1000
    x, w_q, scale = torch.zeros(m, k), torch.zeros(k, n, dtype=torch.int8), torch.ones(n)
    before = quant_matmul.launches
    lib = _StubInt8Lib(rc=9)   # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="cudaGetLastError"):
        quant_matmul._launch(lib, x, w_q, scale, 0, 132)
    assert quant_matmul.launches == before
    # pointers, then M, N, K, k rows per split, splits, word loads of w_q and of x, stream
    splits, per = quant_matmul.k_splits(k, n, 132, quant_matmul.TILE_N[torch.float32])
    assert len(lib.args) == 13 and lib.args[5:12] == (m, n, k, per, splits, 1, 1)
    y = quant_matmul._launch(_StubInt8Lib(rc=0), x, w_q, scale, 0, 132)
    assert tuple(y.shape) == (m, n) and y.dtype == x.dtype
    assert quant_matmul.launches == before + 1
    quant_matmul.launches = before


@pytest.mark.parametrize("bad,error,match", [
    ({"x": _meta(7, 96, dtype=torch.float16)}, TypeError, "float32 or bfloat16"),
    ({"w_q": _meta(96, 48)}, TypeError, "w_q must be int8"),
    ({"w_q": _meta(48, 96, dtype=torch.int8).t()}, ValueError, "w_q must be contiguous"),
    ({"scale": _meta(48, dtype=torch.float64)}, ValueError, "scale must be float32"),
    ({"scale": _meta(47)}, ValueError, "scale must be float32"),
    ({"x": _meta(7, 95)}, ValueError, r"not \[M, K\]"),
    ({"x": _meta(7, 96).t().contiguous().t()}, ValueError, "x must be contiguous"),
    ({}, ValueError, "unsupported device"),
])
def test_int8_wrapper_refuses_what_the_kernel_does_not_take(bad, error, match):
    args = {"x": _meta(7, 96), "w_q": _meta(96, 48, dtype=torch.int8), "scale": _meta(48)}
    args.update(bad)
    with pytest.raises(error, match=match):
        quant_matmul.int8_matmul(**args)
