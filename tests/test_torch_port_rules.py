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
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.models import (alexnet, lenet, lstm_classifier, mlp_mnist,
                                             resnet50, simple_cnn, text_gen_lstm, vgg16, vgg19)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.models import BertConfig, BertForMaskedLM
from deeplearning4j_tpu_torch.nn.quantize import quantize_net
from deeplearning4j_tpu_torch.ops.kernels import (_build, conv3_bn, conv_bn, flash_attention,
                                                  quant_matmul)
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
                   "ops/kernels/quant_matmul.py", "interop.py", "serve/engine.py",
                   "data/datasets.py", "evaluation/classification.py", "evaluation/roc.py",
                   "evaluation/regression.py", "evaluation/calibration.py",
                   "nn/layers/recurrent.py", "train/trainer.py", "train/updaters.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names


def test_profile_counts_every_kernel_of_the_port_in_its_own_category():
    """chip_profile.py files each CUDA kernel of csrc/ under a named
    category, never under "other" or a library category."""
    import re
    import chip_profile
    ours = {"int8_matmul", "matmul_bn_act", "matmul_bn_act_bwd", "flash_attention",
            "flash_attention_bwd", "flash_attention_bwd_split", "conv3x3_bn_act"}
    for src in sorted(_build.CSRC.glob("*.cu")):
        names = re.findall(r"__global__.*?\b(\w+_kernel)\(", src.read_text(), re.S)
        assert names, src.name
        for name in names:
            assert chip_profile.category(name) in ours, (src.name, name)


def test_no_jax_scan_covers_the_conv3_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("ops/kernels/conv3_bn.py", "nn/layers/fused.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names


def test_no_jax_scan_covers_the_bert_headline_slice():
    """The obs/ subpackage and the modules of the seq-128 headline and the
    config-first attention stack are scanned too."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("obs/__init__.py", "obs/listeners.py", "data/device_pipeline.py",
                   "nn/layers/attention.py", "nn/layers/norm.py", "nn/layers/core.py",
                   "nn/vertices.py", "nn/preprocessors.py", "train/updaters.py",
                   "models/bert.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names


def test_port_reads_no_dl4j_tpu_environment_variable():
    for path in PORT_FILES:
        assert "DL4J_TPU_" not in path.read_text(), path


def test_no_jax_scan_covers_the_training_slice():
    """The schedules, early stopping, transfer learning, the checkpoint
    modules and the resilience subpackage are scanned too."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("train/schedules.py", "train/early_stopping.py", "nn/transfer.py",
                   "io/model_serializer.py", "io/checkpoint.py", "resilience/__init__.py",
                   "resilience/checkpoint.py", "data/dataset.py", "data/iterators.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_module_reads_the_resume_pointer(path):
    """The JAX package's supervisor hands a respawned worker its checkpoint
    through an environment variable that ``Trainer.fit`` reads; the port
    reads no environment for a resume (nothing of ``os.environ`` or
    ``getenv`` names it, and ``fit`` resumes only from ``resume_from``)."""
    text = path.read_text()
    assert "DL4J_TPU_RESUME_FROM" not in text and "RESUME_ENV" not in text, path
    for node in ast.walk(ast.parse(text, filename=str(path))):
        reads_env = (isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv")
                     or isinstance(node, ast.Name) and node.id in ("environ", "getenv"))
        if reads_env:
            line = text.splitlines()[node.lineno - 1]
            assert "RESUME" not in line.upper(), (path, node.lineno, line)


def test_fit_ignores_a_resume_pointer_in_the_environment(monkeypatch, tmp_path):
    rng = np.random.default_rng(1)
    x = rng.random((8, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    net = mlp_mnist(hidden=8, hidden2=4, device="cpu").init()
    net.fit(ArrayDataSetIterator(x, y, 4), 1)
    net.save(str(tmp_path / "c.zip"))
    monkeypatch.setenv("DL4J_TPU_RESUME_FROM", str(tmp_path / "c.zip"))
    fresh = mlp_mnist(hidden=8, hidden2=4, device="cpu").init()
    fresh.fit(ArrayDataSetIterator(x, y, 4), 1)
    assert (fresh.iteration, fresh.epoch) == (2, 1)     # a fresh run, not a resumed one


def test_model_loads_default_to_the_card_and_raise_without_one(no_card, tmp_path):
    from deeplearning4j_tpu_torch.io.model_serializer import restore_model
    path = str(tmp_path / "m.zip")
    mlp_mnist(hidden=8, hidden2=4, device="cpu").init().save(path)
    for load in (MultiLayerNetwork.load, restore_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(path)
    assert MultiLayerNetwork.load(path, device="cpu").device == torch.device("cpu")
    graph = str(tmp_path / "g.zip")
    ComputationGraph(_tiny_graph_conf(), device="cpu").init().save(graph)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph.load(graph)
    assert ComputationGraph.load(graph, device="cpu").device == torch.device("cpu")


def _tiny_graph_conf():
    """A two-layer graph configuration (dense, softmax)."""
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    g = (NeuralNetConfiguration.builder().seed(1).graph().add_inputs("in")
         .set_input_types(InputType.feed_forward(6)))
    g.add_layer("d", DenseLayer(n_out=5, activation="relu"), "in")
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "d")
    return g.set_outputs("out").build()


def test_cpu_frozen_fine_tune_with_checkpoints_never_touches_the_kernel_loader(
        monkeypatch, tmp_path):
    """A ResNet-50 (32x32) with its stem and res2-res4 frozen and its own
    head updater fine-tunes, checkpoints and resumes on the CPU through the
    plain versions: no build, no launch."""
    from deeplearning4j_tpu_torch.data import ResumableIterator
    from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.train import AdamW, ExponentialSchedule, RampSchedule

    def refuse(*args, **kwargs):
        raise AssertionError("kernel loader reached on a CPU run")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    before = (conv_bn.launches, conv_bn.bwd_launches)
    net = resnet50(height=32, width=32, num_classes=5, device="cpu")
    for spec in net._topo:
        if spec.kind == "layer" and spec.name.startswith(("stem", "res2_", "res3_", "res4_")):
            spec.obj.frozen = True
    net.layers[-1].updater = AdamW(RampSchedule(underlying=ExponentialSchedule(
        initial_value=1e-3, gamma=0.99), num_iterations=4))
    net.init(seed=2)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)]
    frozen = net.params_["res4_5"]["W_a"].clone()
    net.fit(ResumableIterator(ArrayDataSetIterator(x, y, 4)), 1,
            listeners=[CheckpointListener(str(tmp_path), save_every_n_epochs=1)])
    assert torch.equal(net.params_["res4_5"]["W_a"], frozen) and np.isfinite(net.score())
    again = ComputationGraph(net.conf, device="cpu").init(seed=2)
    again.fit(ResumableIterator(ArrayDataSetIterator(x, y, 4)), 2, resume_from=str(tmp_path))
    assert (again.iteration, again.epoch) == (4, 2)
    assert (conv_bn.launches, conv_bn.bwd_launches) == before


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



@pytest.mark.parametrize("factory", [mlp_mnist, lenet, simple_cnn, alexnet, vgg19,
                                     lstm_classifier, text_gen_lstm],
                         ids=lambda f: f.__name__)
def test_small_zoo_entries_default_to_the_card_and_raise_without_one(no_card, factory):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory()
    assert factory(device="cpu").device == torch.device("cpu")


def test_cpu_lenet_fit_never_touches_the_kernel_loader(monkeypatch):
    """LeNet trains and evaluates on the CPU through plain torch ops: no
    build, no launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("kernel loader reached on a CPU run")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    rng = np.random.default_rng(0)
    x = rng.random((8, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    net = lenet(device="cpu").init()
    net.fit(ArrayDataSetIterator(x, y, 4), 1)
    assert net.iteration == 2 and np.isfinite(net.score())
    assert net.evaluate(ArrayDataSetIterator(x, y, 4)).total == 8


def test_dropout_step_on_a_card_net_refuses_a_host_generator(monkeypatch):
    """A CUDA-placed net with dropout set takes its masks from a generator
    on the card: a CPU generator is refused before anything is drawn."""
    net = alexnet(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    net.device = torch.device("cuda")     # a net made where a card was
    net.params_, net.state_ = [{} for _ in net.layers], [{} for _ in net.layers]
    trainer = Trainer(net)
    batch = DataSet(np.zeros((1, 224, 224, 3), np.float32), np.eye(1000, dtype=np.float32)[:1])
    with pytest.raises(ValueError, match="generator on cpu"):
        trainer.fit_batch(batch, torch.Generator())
    with pytest.raises(TypeError, match="torch.Generator"):
        trainer.fit_batch(batch, 0)


class _StubLib:
    """Stands in for the built library: returns ``rc`` from the launch, as
    cudaGetLastError() would, and keeps the arguments of each call."""

    def __init__(self, rc):
        self.rc = rc
        self.calls = []

    def matmul_bn_act_f32(self, *args):
        self.calls.append(args)
        return self.rc

    matmul_bn_act_bf16 = matmul_bn_act_f32


def test_failed_launch_raises_and_is_not_counted():
    x, w = torch.zeros(4, 32), torch.zeros(32, 32)
    before = conv_bn.launches
    lib = _StubLib(rc=9)   # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="cudaGetLastError"):
        conv_bn._launch(lib, x, w, None, None, True, 0, 132)
    assert len(lib.calls) == 1 and conv_bn.launches == before
    conv_bn._launch(_StubLib(rc=0), x, w, None, None, True, 0, 132)
    assert conv_bn.launches == before + 1
    conv_bn.launches = before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,prologue", [(1568, 2048, 512, True), (300, 100, 24, False),
                                            (100352, 64, 256, False)])
def test_forward_makes_one_call_and_allocates_y_and_one_buffer(monkeypatch, dtype, m, k, n,
                                                                prologue):
    """The forward's one library call: x, w, a, b and y, then pointers into
    one f32 buffer at the plan's offsets (sums, stats, part when split, the
    f32 weight's transpose), the plan's count of arrival counts, M, N, K,
    the row pitches, the splits, blocks and table rows, relu_in, the
    stream; beside row-padded copies of x and W where the TMA needs them,
    it allocates y and the buffer and nothing else, and s1, s2 are the
    buffer's first 2N entries."""
    x, w = torch.zeros(m, k, dtype=dtype), torch.zeros(k, n, dtype=dtype)
    a, b = (torch.ones(k), torch.zeros(k)) if prologue else (None, None)
    xk, wk = conv_bn.row_aligned(x), (w if dtype == torch.float32 else conv_bn.row_aligned(w))
    allocated = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a_, **kw: allocated.append(real_empty(*a_, **kw))
                        or allocated[-1])
    lib = _StubLib(rc=0)
    before = conv_bn.launches
    y, s1, s2 = conv_bn._launch(lib, x, w, a, b, False, 7, 132)
    monkeypatch.undo()
    conv_bn.launches = before
    p = conv_bn.fwd_plan(m, k, n, dtype, 132)
    assert [tuple(t.shape) for t in allocated] == [(m, n), (p["floats"],)]
    y_, buf = allocated
    assert y_ is y and y.dtype == dtype and buf.dtype == torch.float32
    assert s1.data_ptr() == buf.data_ptr() and s2.data_ptr() == buf.data_ptr() + 4 * n
    assert tuple(s1.shape) == tuple(s2.shape) == (n,)
    (args,) = lib.calls
    at = {key: buf.data_ptr() + 4 * off for key, off in p["at"].items()}
    assert len(args) == 21 and args[-1] == 7
    assert args[2:5] == (a.data_ptr() if prologue else None, b.data_ptr() if prologue else None,
                         y.data_ptr())
    assert args[5:8] == (at["sums"], at["stats"], at["part"] if p["splits"] > 1 else None)
    assert args[8] == (at["wt"] if dtype == torch.float32 else None)
    assert args[9] == at["counts"] and args[10] == p["shapes"]["counts"][0]
    assert args[11:20] == (m, n, k, xk.shape[1], wk.shape[1], p["splits"], p["blocks"],
                           p["rows"], 0)
    if xk is x:
        assert args[0] == x.data_ptr()
    if wk is w:
        assert args[1] == w.data_ptr()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    meta = torch.empty(4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_bn.matmul_bn_act(meta, torch.empty(32, 32, device="meta"))
    with pytest.raises(ValueError, match="both a and b"):
        conv_bn.matmul_bn_act(torch.zeros(4, 32), torch.zeros(32, 32), torch.ones(32), None)


class _StubBwdLib:
    """The built backward library: ``rc`` from the launch."""

    def __init__(self, rc):
        self.rc = rc
        self.args = None

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
    # pointers, then M, N, K, the row pitches of x, w and y/dy, splits,
    # relu_in, stream; one launch of the pair, no reduce kernels
    assert len(lib.args) == 24 and lib.args[15:18] == (m, n, k)
    assert lib.args[18:21] == (k, n, n)                    # rows already 16-byte multiples
    assert lib.args[21] == conv_bn.bwd_plan(m, k, n, torch.float32, 114)["splits"]
    assert (lib.args[11] is None) == (not prologue)       # db only with a prologue
    assert (lib.args[13] is None) == (not prologue)       # so are the da/db sums
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
    # any K and N: a ragged N passes the shape checks and stops at the device
    ({"w": _meta(32, 48), "dy": _meta(64, 48), "y": _meta(64, 48),
      "ds1": _meta(48), "ds2": _meta(48)}, ValueError, "unsupported device"),
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
    # any head dim passes the shape checks and stops at the device
    ({"q": torch.zeros(1, 2, 8, 32), "k": torch.zeros(1, 2, 8, 32)}, ValueError,
     "unsupported device"),
    ({"q": torch.zeros(1, 2, 8, 192), "k": torch.zeros(1, 2, 8, 192)}, ValueError,
     "unsupported device"),
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

    flash_attention_fwd_f32 = flash_attention_bwd_f32 = flash_attention_bwd_split_f32 = _call


def test_failed_flash_launches_raise_and_are_not_counted(monkeypatch):
    q, k = torch.zeros(2, 3, 70, 64), torch.zeros(2, 3, 130, 64)
    mask = torch.ones(2, 130)
    before = (flash_attention.launches, flash_attention.bwd_launches)
    lib = _StubFlashLib(rc=9)   # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="cudaGetLastError"):
        flash_attention._launch_fwd(lib, q, k, k, mask, 0.125, False, 0, 0, False, 0)
    # pointers, then bh, heads, tq, tk, q_offset, k_offset, causal, normalize, head dim;
    # scale; stream
    assert len(lib.args) == 20 and lib.args[9:18] == (6, 3, 70, 130, 0, 0, 0, 0, 64)
    lse = torch.zeros(2, 3, 70)
    allocated = []
    real_zeros = torch.zeros
    with monkeypatch.context() as m:   # see what the merged form allocates
        m.setattr(torch, "zeros", lambda *a, **kw: allocated.append(real_zeros(*a, **kw))
                  or allocated[-1])
        with pytest.raises(RuntimeError, match="cudaGetLastError"):
            flash_attention._launch_bwd(lib, q, k, k, None, q, lse, lse, 0.125, True, 5, 0, 0)
    # pointers q, k, v, key_mask, dout, lse, delta, dq, dk, dv, flags, then bh,
    # heads, tq, tk, q_offset, k_offset, causal, head dim; scale; stream
    assert len(lib.args) == 21 and lib.args[3] is None
    assert lib.args[11:19] == (6, 3, 70, 130, 5, 0, 1, 64)
    # dq starts at zero (the key tiles add into it) and the flags that order
    # the adds are the only scratch: one ticket and one flag per (batch, head,
    # 64-row query tile), no per-key-tile partials
    dq, flags = allocated
    assert dq.shape == q.shape and dq.dtype == torch.float32 and not dq.any()
    assert flags.dtype == torch.int32 and flags.numel() == 1 + 6 * 2 and not flags.any()
    assert lib.args[7] == dq.data_ptr() and lib.args[10] == flags.data_ptr()
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


def test_flash_sources_name_every_header_they_include():
    """The forward and both backward libraries are hashed with the shared
    header and the Hopper one (wgmma, TMA, the query-tile ring), so an edit
    to either rebuilds every flash library."""
    for name in ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_bwd_split"):
        names = {p.name for p in _build.source_files(name)}
        assert names == {f"{name}.cu", "flash_attention.cuh", "flash_attention_sm90.cuh"}


@pytest.mark.parametrize("name", ["conv3x3_bn_act", "matmul_bn_act", "matmul_bn_act_bwd",
                                  "int8_matmul"])
def test_gemm_sources_name_the_shared_core(name):
    """The libraries on the GEMM core are hashed with it and with the
    Hopper headers below it, so an edit to any rebuilds all four."""
    names = {p.name for p in _build.source_files(name)}
    assert names == {f"{name}.cu", "gemm_sm90.cuh", "flash_attention.cuh",
                     "flash_attention_sm90.cuh"}


@pytest.mark.parametrize("normalize", [True, False])
def test_flash_forward_passes_its_outputs_and_no_scratch(monkeypatch, normalize):
    """The forward's 20 arguments: its outputs (out and lse, or o, m and l)
    are the only buffers it is handed beside q, k, v and the mask, and it
    allocates nothing else."""
    q, k = torch.zeros(2, 3, 70, 64), torch.zeros(2, 3, 130, 64)
    allocated = []
    real_empty, real_empty_like = torch.empty, torch.empty_like
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: allocated.append(real_empty(*a, **kw))
                        or allocated[-1])
    monkeypatch.setattr(torch, "empty_like",
                        lambda *a, **kw: allocated.append(real_empty_like(*a, **kw))
                        or allocated[-1])
    lib = _StubFlashLib(rc=0)
    outs = flash_attention._launch_fwd(lib, q, k, k, None, 0.125, True, 3, 0, normalize, 0)
    monkeypatch.undo()
    flash_attention.launches -= 1
    assert len(lib.args) == 20 and lib.args[9:18] == (6, 3, 70, 130, 3, 0, 1, int(normalize), 64)
    assert [t.data_ptr() for t in allocated] == [t.data_ptr() for t in outs]
    # pointers q, k, v, key_mask, o, m, l, out, lse
    given = lib.args[4:7] if not normalize else lib.args[7:9]
    assert list(given) == [t.data_ptr() for t in outs]
    assert all(p is None for p in (lib.args[7:9] if not normalize else lib.args[4:7]))


def test_failed_split_backward_launch_raises_and_is_not_counted():
    """The two-kernel backward: no scratch among its pointers, the head
    dim among its ints, two launches counted per call that succeeds."""
    q, k = torch.zeros(2, 3, 70, 32), torch.zeros(2, 3, 130, 32)
    lse = torch.zeros(2, 3, 70)
    before = (flash_attention.bwd_launches, flash_attention.split_launches)
    lib = _StubFlashLib(rc=9)
    with pytest.raises(RuntimeError, match="cudaGetLastError"):
        flash_attention._launch_bwd_split(lib, q, k, k, None, q, lse, lse, 0.125, True, 5, 0, 0)
    # pointers q, k, v, key_mask, dout, lse, delta, dq, dk, dv, then bh, heads,
    # tq, tk, q_offset, k_offset, causal, head dim; scale; stream
    assert len(lib.args) == 20 and lib.args[3] is None
    assert lib.args[10:18] == (6, 3, 70, 130, 5, 0, 1, 32)
    assert (flash_attention.bwd_launches, flash_attention.split_launches) == before
    dq, dk, dv = flash_attention._launch_bwd_split(_StubFlashLib(rc=0), q, k, k, None, q, lse,
                                                   lse, 0.125, False, 0, 0, 0)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape and dq.dtype == torch.float32
    assert (flash_attention.bwd_launches, flash_attention.split_launches) == (before[0],
                                                                              before[1] + 2)
    flash_attention.split_launches = before[1]


@pytest.mark.parametrize("merged", [True, False])
def test_flash_backward_refuses_a_bad_dtype_on_either_form(merged):
    """A tensor off the CPU that the kernels do not take raises before any
    launch, in both forms of the backward."""
    q = _meta(1, 2, 8, 64, dtype=torch.float16)
    lse = _meta(1, 2, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_attention_block_bwd(q, q, q, q, lse, q, scale=0.125,
                                                  merged=merged)


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
    # pointers (x, w_q, scale, y, the split partials and arrival counts), then
    # M, N, K, the row pitches of x and w_q (N = 1000 is no multiple of 16
    # bytes: a copy with rows padded to 1008), k rows per split, splits, stream
    splits, per = quant_matmul.k_splits(k, n, 132, quant_matmul.TILE_N[torch.float32])
    assert len(lib.args) == 14 and lib.args[6:13] == (m, n, k, k, 1008, per, splits)
    assert (lib.args[4] is None) == (lib.args[5] is None) == (splits == 1)
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


def test_cpu_conv3_run_never_touches_the_kernel_loader(monkeypatch):
    """The 3x3 op forward and backward on CPU tensors: the plain version
    and autograd of the reference, no build, no launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("kernel loader reached on a CPU run")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    x = torch.randn(2, 5, 4, 8, requires_grad=True)
    w = torch.randn(3, 3, 8, 6, requires_grad=True)
    before = conv3_bn.launches
    y, s1, s2 = conv3_bn.conv3x3_bn_act(x, w, torch.ones(8), torch.zeros(8))
    (y.sum() + s1.sum() + s2.sum()).backward()
    assert tuple(y.shape) == (2, 5, 4, 6) and x.grad is not None and w.grad is not None
    assert conv3_bn.launches == before


@pytest.mark.parametrize("bad,error,match", [
    ({"x": _meta(2, 6, 5, 16, dtype=torch.float16), "w": _meta(3, 3, 16, 24, dtype=torch.float16)},
     TypeError, "float32 or bfloat16"),
    ({"w": _meta(3, 3, 16, 24, dtype=torch.bfloat16)}, TypeError, "w must match"),
    ({"w": _meta(1, 1, 16, 24)}, ValueError, r"not \[N, H, W, C\] and \[3, 3, C, Cout\]"),
    ({"w": _meta(3, 3, 8, 24)}, ValueError, r"not \[N, H, W, C\] and \[3, 3, C, Cout\]"),
    ({"x": _meta(2, 6, 16, 5).transpose(2, 3)}, ValueError, "x must be contiguous"),
    ({"w": _meta(3, 3, 24, 16).transpose(2, 3)}, ValueError, "w must be contiguous"),
    ({"a": _meta(15), "b": _meta(15)}, ValueError, "a must be float32"),
    ({"b": _meta(16, dtype=torch.float64)}, ValueError, "b must be float32"),
    ({"b": None}, ValueError, "both a and b"),
    # any N, H, W, C and Cout pass the shape checks and stop at the device
    ({"x": _meta(3, 7, 5, 3), "w": _meta(3, 3, 3, 5), "a": _meta(3), "b": _meta(3)}, ValueError,
     "unsupported device"),
    ({"a": None, "b": None}, ValueError, "unsupported device"),
    ({}, ValueError, "unsupported device"),
])
def test_conv3_wrapper_refuses_what_the_kernel_does_not_take(bad, error, match):
    args = {"x": _meta(2, 6, 5, 16), "w": _meta(3, 3, 16, 24), "a": _meta(16), "b": _meta(16)}
    args.update(bad)
    before = conv3_bn.launches
    with pytest.raises(error, match=match):
        conv3_bn.conv3x3_bn_act(args["x"], args["w"], args["a"], args["b"], relu_in=True)
    assert conv3_bn.launches == before


class _StubConv3Lib:
    """The built library: ``rc`` from the launch."""

    def __init__(self, rc):
        self.rc = rc
        self.args = None

    def conv3x3_bn_act_f32(self, *args):
        self.args = args
        return self.rc


@pytest.mark.parametrize("prologue", [False, True])
def test_failed_conv3_launch_raises_and_is_not_counted(prologue):
    x, w = torch.zeros(3, 9, 11, 24), torch.zeros(3, 3, 24, 40)
    a, b = (torch.ones(24), torch.zeros(24)) if prologue else (None, None)
    before = conv3_bn.launches
    lib = _StubConv3Lib(rc=9)   # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="cudaGetLastError"):
        conv3_bn._launch(lib, x, w, a, b, True, 0)
    assert conv3_bn.launches == before
    # pointers x, w, w_lo, a, b, y, part, stats, counts, s1, s2, then N, H, W,
    # C padded to the f32 chunk, x's rows, Cout, Cout padded to the tile,
    # splits (297 pixels fill 3 tiles: K splits over its 1 chunk, so 1),
    # relu_in, stream
    assert len(lib.args) == 21 and lib.args[11:20] == (3, 9, 11, 32, 297, 40, 64, 1, 1)
    assert (lib.args[3] is None) == (not prologue) and lib.args[6] is None
    y, s1, s2 = conv3_bn._launch(_StubConv3Lib(rc=0), x, w, a, b, False, 0)
    assert tuple(y.shape) == (3, 9, 11, 40) and y.dtype == x.dtype
    assert s1.shape == s2.shape == (40,) and s1.dtype == torch.float32
    assert conv3_bn.launches == before + 1
    conv3_bn.launches = before


def test_conv3_grid_limit_is_refused():
    lib = _StubConv3Lib(rc=0)
    x = torch.empty(1, 128 * 65536 + 1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="past the kernel's grid"):
        conv3_bn._launch(lib, x, torch.empty(3, 3, 8, 8, device="meta"), None, None, True, 0)
    assert lib.args is None


SERVING_STACK = ("obs/registry.py", "obs/tracing.py", "obs/flight_recorder.py",
                 "resilience/faults.py", "obs/health.py", "serve/engine.py",
                 "serve/registry.py", "serve/router.py", "serve/autoscale.py",
                 "serve/feedback.py", "serve/server.py", "online/source.py",
                 "online/gate.py", "online/loop.py", "online/__init__.py")


def test_no_jax_scan_covers_the_serving_stack():
    """The serving stack's modules are scanned for JAX imports and for
    ``DL4J_TPU_`` (the two tests above run over every file listed here)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in SERVING_STACK + ("serve/__init__.py", "nn/layers/core.py", "nn/quantize.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names
        text = (ROOT / "deeplearning4j_tpu_torch" / module).read_text()
        assert "DL4J_TPU_" not in text and "os.environ" not in text, module


def test_model_registry_defaults_to_the_card_and_raises_without_one(no_card, tmp_path):
    from deeplearning4j_tpu_torch.online import GatedDeployer, EvalGate
    from deeplearning4j_tpu_torch.serve import ModelRegistry
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry(device="cuda", max_batch=4)
    reg = ModelRegistry(device="cpu")
    assert reg.device == torch.device("cpu")
    path = str(tmp_path / "m.zip")
    mlp_mnist(hidden=8, hidden2=4, device="cpu").init().save(path)
    from deeplearning4j_tpu_torch.serve.registry import load_for_serving
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_for_serving(path)                       # the registry's load: the card by default
    reg.deploy("m", path)
    assert reg.get("m").engine.model.device == torch.device("cpu")
    assert GatedDeployer(reg, EvalGate([]))._device() == torch.device("cpu")
    reg.close()


def test_cpu_serving_stack_run_never_touches_the_kernel_loader(monkeypatch, tmp_path):
    """Deploy fp and int8 through the registry on the CPU, serve over HTTP
    and through a two-replica router, with tracing on: the plain versions,
    no build, no launch."""
    import http.client
    import json
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.obs import tracing
    from deeplearning4j_tpu_torch.serve import ModelRegistry, ModelServer, ReplicaRouter

    def refuse(*args, **kwargs):
        raise AssertionError("kernel loader reached on a CPU run")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    x = np.random.default_rng(0).normal(size=(3, 8, 8, 3)).astype(np.float32)
    path = str(tmp_path / "vgg.zip")
    _tiny_vgg().init(seed=2).save(path, save_updater=False)
    before = quant_matmul.launches
    reg = ModelRegistry(device="cpu", max_batch=4, max_latency_ms=1)
    config.set_config(tracing=True)
    try:
        with tracing.use_tracer(tracing.Tracer()) as tracer:
            reg.deploy("v", path, precision="int8", calibration=[x])
            reg.deploy("w", path)
            with ModelServer(reg) as srv:
                conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
                conn.request("POST", "/v1/models/v:predict",
                             json.dumps({"instances": x.tolist()}))
                r = conn.getresponse()
                body = json.loads(r.read())
                assert r.status == 200 and np.asarray(body["predictions"]).shape == (3, 10)
            router = ReplicaRouter(reg, "w", replicas=2)
            assert router.predict(x, timeout_s=60).shape == (3, 10)
            reg.close()
        serves = tracer.find("serve")
        assert len(serves) == 2 and all(s.attributes["rows"] == 3 for s in serves)
    finally:
        config.set_config(tracing=False)
    assert quant_matmul.launches == before
