#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit code and
no result line:

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from the sources in this checkout;
3. for each distinct (K, N, prologue) of the 36 ``matmul_bn_act`` calls
   of ResNet-50 at batch 32 x 224 x 224, in f32 and bf16: hold the kernel
   to ``matmul_bn_act_plain`` on the card, and time the kernel, the plain
   version and one library yardstick (``torch.matmul`` with the prologue
   and the statistics as torch ops);
4. serve full-width ResNet-50 (224x224x3, 1000 classes, 16 fused
   bottlenecks, seeded weights) through ``InferenceEngine(max_batch=32)``:
   16 requests of 1-8 images from 4 threads.  Every answer must match a
   direct forward of the same images, the whole forward through the
   kernel must match the same net with the plain version (in log
   probabilities), and the kernel must have launched 36 times per
   dispatched batch.  The 16 requests are a smoke reading of the engine,
   not a throughput metric: the forward alone at batch 32 is timed for
   that;
5. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

f32 means full f32 here: TF32 is switched off for cuBLAS and cuDNN
(``allow_tf32 = False``) for the whole run, so the plain versions and the
convolutions around the kernel compute in f32 as the JAX package's
HIGHEST precision does.  The per-shape table goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 32
SEED = 20261016
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# kernel vs plain on the same inputs, max |diff| over a scale of the result:
# y against max|y|; s1 against max_n sum_m |y|; s2 against max|s2|.  f32: sum
# order only (K up to 2048 terms); bf16: y rounds to bf16 (2^-8 relative).
TOL = {"float32": {"y": 1e-5, "s1": 1e-5, "s2": 1e-5},
       "bfloat16": {"y": 8e-3, "s1": 1e-4, "s2": 1e-4}}
SERVE_TOL = 1e-5      # engine answer vs direct forward of the same images
# forward through the kernel vs through the plain version, as max |diff| of
# log probabilities: logits up to a per-row shift, i.e. each probability's
# error over its own size.  The probabilities sit near 1/1000, so an absolute
# limit on them would let a wiring fault of the layer through; f32 sum order
# alone stays far below this limit over the 16 blocks.
PLAIN_FWD_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_usage(name: str, nvcc_log: str) -> dict:
    """Kernel name -> ptxas's "Used N registers, ... smem" line."""
    from deeplearning4j_tpu_torch.ops.kernels import _build
    known = re.findall(r"\b(\w+_kernel)\(", (_build.CSRC / f"{name}.cu").read_text())
    usage, kernel = {}, None
    for line in nvcc_log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in known if k in line), line)
        elif "Used" in line and kernel:
            usage[kernel] = line.split(":", 1)[1].strip()
    return usage


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def resnet50_calls(net, batch: int) -> list[tuple]:
    """(M, K, N, prologue) of every matmul_bn_act call in one forward."""
    from deeplearning4j_tpu_torch.nn.layers import FusedBottleneck
    calls = []
    for spec in net._topo:
        layer = spec.obj
        if not isinstance(layer, FusedBottleneck):
            continue
        t = net._arriving[spec.name][0]
        sh, sw = layer.stride
        m = batch * (-(-t.height // sh)) * (-(-t.width // sw))
        f1, f2, f3 = layer.filters
        calls += [(m, t.channels, f1, False), (m, f2, f3, True)]
        if layer.project:
            calls.append((m, t.channels, f3, False))
    return calls


def library_matmul_bn_act(x, w, a, b):
    """Yardstick only, never on the port's path: torch.matmul in x's dtype
    (cuBLAS) with the prologue and the statistics as torch ops."""
    import torch
    xh = x if a is None else torch.relu(x * a + b).to(x.dtype)
    y = torch.matmul(xh, w)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def check_kernels(calls) -> list[dict]:
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for (m, k, n, pro) in sorted(set(calls)):
            x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5).to(dtype)
            a = torch.rand(k, device="cuda", generator=gen) + 0.5 if pro else None
            b = torch.randn(k, device="cuda", generator=gen) * 0.2 if pro else None
            y, s1, s2 = conv_bn.matmul_bn_act(x, w, a, b, relu_in=True)
            torch.cuda.synchronize()
            ye, s1e, s2e = conv_bn.matmul_bn_act_plain(x, w, a, b, relu_in=True)
            yd = (y.float() - ye.float()).abs().max().item()
            errs = {"y": yd / ye.float().abs().max().item(),
                    "s1": (s1 - s1e).abs().max().item()
                    / ye.float().abs().sum(0).max().item(),
                    "s2": (s2 - s2e).abs().max().item() / s2e.abs().max().item()}
            bad = {key: v for key, v in errs.items() if not v <= TOL[dname][key]}
            if bad:
                raise AssertionError(f"matmul_bn_act {dname} M={m} K={k} N={n} "
                                     f"prologue={pro}: errors {bad} over {TOL[dname]}")
            isz = x.element_size()
            nbytes = (m * k + k * n + m * n) * isz + (2 * k * 4 if pro else 0) + 2 * n * 4
            flops = 2 * m * k * n
            row = {"dtype": dname, "M": m, "K": k, "N": n, "prologue": pro,
                   "count": calls.count((m, k, n, pro)),
                   "max_abs_err": yd, "rel_err": errs,
                   "ms": cuda_ms(lambda: conv_bn.matmul_bn_act(x, w, a, b, relu_in=True)),
                   "plain_ms": cuda_ms(lambda: conv_bn.matmul_bn_act_plain(x, w, a, b,
                                                                           relu_in=True)),
                   "library_ms": cuda_ms(lambda: library_matmul_bn_act(x, w, a, b)),
                   "bytes_ms": nbytes / PEAK_BYTES * 1e3,
                   "ops_ms": flops / PEAK_FLOPS[dname] * 1e3}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            rows.append(row)
            log(f"  {dname:8s} M={m:6d} K={k:4d} N={n:4d} pro={int(pro)} x{row['count']}: "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
                f"library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"({'bytes' if row['bytes_ms'] >= row['ops_ms'] else 'operations'}), "
                f"rel err y {errs['y']:.2e} s1 {errs['s1']:.2e} s2 {errs['s2']:.2e}")
            del x, w, y, ye
    return rows


def per_forward(rows, dname: str) -> dict:
    """Sums over the 36 launches of one batch-32 forward."""
    sel = [r for r in rows if r["dtype"] == dname]
    tot = {key: sum(r[key] * r["count"] for r in sel)
           for key in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
    tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in sel)
    return tot


def build_net():
    """Full-width ResNet-50 with seeded weights.  The residual-branch BN
    gammas are damped (x0.3, as in the CPU tests) so that 16 blocks of
    random weights keep activations O(1) and the softmax unsaturated:
    otherwise every comparison below would compare one-hot vectors."""
    from deeplearning4j_tpu_torch.models import resnet50
    return damp_residual_gammas(resnet50(fused=True, device="cuda").init(seed=SEED))


def damp_residual_gammas(net, factor: float = 0.3):
    for d in net.params_.values():
        for key in ("gamma_c", "gamma_proj"):
            if key in d:
                d[key].mul_(factor)
    return net


def log_prob_err(p, q) -> float:
    """max |log p - log q| of two softmax outputs: their logits' difference
    up to a per-row shift, each probability's error over its own size."""
    return (p.log() - q.log()).abs().max().item()


def serve(net, card: str) -> dict:
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nn.layers import fused as fused_mod
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    from deeplearning4j_tpu_torch.serve import InferenceEngine

    rng = np.random.default_rng(SEED)
    sizes = [int(s) for s in rng.integers(1, 9, size=16)]
    images = rng.normal(size=(sum(sizes), 224, 224, 3)).astype(np.float32)
    offsets = np.cumsum([0] + sizes)
    requests = [images[offsets[i]:offsets[i + 1]] for i in range(len(sizes))]

    warm = net.output(images[:BATCH])          # cuDNN and allocator warm-up
    torch.cuda.synchronize()
    assert tuple(warm.shape) == (min(BATCH, len(images)), 1000)

    answers, latency = {}, {}
    conv_bn.launches = 0
    engine = InferenceEngine(net, max_batch=BATCH, max_latency_ms=5.0, device="cuda")
    try:
        def client(ids):
            for i in ids:
                t0 = time.perf_counter()
                answers[i] = engine.predict(requests[i], timeout_s=300)
                latency[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=client, args=(list(range(j, len(sizes), 4)),))
                   for j in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("serving clients did not finish")
    finally:
        engine.shutdown()
    launches, batches = conv_bn.launches, engine.batches
    if len(answers) != len(sizes):
        raise AssertionError(f"{len(answers)} of {len(sizes)} requests answered")
    if launches != 36 * batches or batches == 0:
        raise AssertionError(f"matmul_bn_act launched {launches} times for {batches} batches")

    # every answer against a direct forward of the same images
    serve_err = 0.0
    for i, req in enumerate(requests):
        direct = net.output(req).cpu().numpy()
        a = answers[i]
        if a.shape != (sizes[i], 1000) or not np.isfinite(a).all():
            raise AssertionError(f"request {i}: answer shape {a.shape} or non-finite")
        serve_err = max(serve_err, float(np.abs(a - direct).max()))
    if not serve_err <= SERVE_TOL:
        raise AssertionError(f"engine answers differ from direct forwards by {serve_err}")

    # the whole forward through the kernel vs through the plain version
    x = torch.from_numpy(images[:BATCH]).cuda()
    y_kernel = net.output(x)
    saved = fused_mod.matmul_bn_act
    fused_mod.matmul_bn_act = conv_bn.matmul_bn_act_plain   # comparison only
    try:
        y_plain = net.output(x)
        plain_fwd_ms = cuda_ms(lambda: net.output(x), reps=5)
    finally:
        fused_mod.matmul_bn_act = saved
    fwd_err = log_prob_err(y_kernel, y_plain)
    if not fwd_err <= PLAIN_FWD_TOL:
        raise AssertionError(f"kernel forward differs from plain forward by {fwd_err} "
                             f"in log probabilities")
    top = y_kernel.max(dim=1).values
    if not (torch.isfinite(y_kernel).all() and top.max().item() < 0.99):
        raise AssertionError("forward is non-finite or saturated")
    kernel_fwd_ms = cuda_ms(lambda: net.output(x), reps=5)

    lat = np.array([latency[i] for i in range(len(sizes))]) * 1e3
    result = {"card": card, "requests": len(sizes), "images": int(sum(sizes)),
              "batches": batches, "launches": launches,
              "images_per_s": sum(sizes) / wall, "wall_s": wall,
              "p50_ms": float(np.percentile(lat, 50)), "max_ms": float(lat.max()),
              "serve_max_abs_err": serve_err, "plain_forward_max_log_prob_err": fwd_err,
              "forward_ms_batch32": kernel_fwd_ms, "plain_forward_ms_batch32": plain_fwd_ms,
              "forward_images_per_s_batch32": BATCH / kernel_fwd_ms * 1e3}
    log(f"serve smoke on {card}: {result['images']} images in {len(sizes)} requests, "
        f"{batches} batches, {launches} kernel launches; "
        f"{result['images_per_s']:.1f} images/s, latency p50 {result['p50_ms']:.1f} ms, "
        f"p99 = max of {len(sizes)} {result['max_ms']:.1f} ms; forward at batch {BATCH}: "
        f"{kernel_fwd_ms:.2f} ms ({result['forward_images_per_s_batch32']:.1f} images/s), "
        f"with the plain version {plain_fwd_ms:.2f} ms; errors: engine {serve_err:.2e}, "
        f"kernel vs plain forward {fwd_err:.2e} (log probabilities)")
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "deeplearning4j_tpu_torch").is_dir():
        print("chip_smoke: the deeplearning4j_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    log(card)

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, info in built.items():
        log(f"  {name}: nvcc {info['seconds']:.1f} s")
        for kernel, usage in ptxas_usage(name, info["log"]).items():
            log(f"    {kernel}: {usage}")

    net = build_net()
    calls = resnet50_calls(net, BATCH)
    if len(calls) != 36:
        raise AssertionError(f"ResNet-50 makes {len(calls)} matmul_bn_act calls, not 36")
    log(f"kernel check: {len(set(calls))} distinct shapes of the 36 calls at batch {BATCH}, "
        f"{sum(2 * m * k * n for m, k, n, _ in calls) / BATCH / 1e9:.3f} GFLOP per image")
    rows = check_kernels(calls)

    serving = serve(net, card)

    f32, bf16 = per_forward(rows, "float32"), per_forward(rows, "bfloat16")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "shapes": rows, "per_forward": {"float32": f32, "bfloat16": bf16},
         "serve": serving, "seconds": time.perf_counter() - t_start}, indent=1))

    kernel = {"name": "matmul_bn_act", "route": "cuda",
              "source": "deeplearning4j_tpu_torch/ops/kernels/csrc/matmul_bn_act.cu",
              "replaces": "deeplearning4j_tpu/ops/pallas/conv_bn.py:58",
              "launches": serving["launches"], "max_abs_err": f32["max_abs_err"],
              "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
              "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
              "work": f"the 36 calls of one ResNet-50 forward at batch {BATCH}, f32",
              "bf16_ms": bf16["ms"], "bf16_plain_ms": bf16["plain_ms"],
              "bf16_bound_ms": bf16["bound_ms"], "bf16_library_ms": bf16["library_ms"],
              "bf16_max_abs_err": bf16["max_abs_err"]}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
