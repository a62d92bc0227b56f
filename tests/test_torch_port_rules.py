"""Rules the PyTorch port keeps: it imports nothing of JAX or of the JAX
package, its entry points default to the CUDA card and raise without one,
a CPU run never reaches the kernel loader, and a failed kernel launch
raises."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.models import resnet50
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops.kernels import _build, conv_bn
from deeplearning4j_tpu_torch.serve import InferenceEngine

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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(net)


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
    with InferenceEngine(net, max_batch=4, device="cpu") as engine:
        assert engine.predict(x, timeout_s=60).shape == (2, 10)
    assert conv_bn.launches == before


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
