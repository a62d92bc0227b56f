#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit code and
no result line:

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from the sources in this checkout (one
   ``nvcc`` per source, all started together);
3. for each distinct (M, K, N, prologue) of the 36 ``matmul_bn_act`` calls
   of ResNet-50 at batch 32 x 224 x 224, in f32 and bf16: hold the forward
   kernel to ``matmul_bn_act_plain`` on the card, and time the kernel, the
   plain version and one library yardstick (``torch.matmul`` with the
   prologue and the statistics as torch ops);
4. serve full-width ResNet-50 (224x224x3, 1000 classes, 16 fused
   bottlenecks, seeded weights) through ``InferenceEngine(max_batch=32)``:
   16 requests of 1-8 images from 4 threads.  Every answer must match a
   direct forward of the same images, the whole forward through the
   kernel must match the same net with the plain version (in log
   probabilities), and the kernel must have launched 36 times per
   dispatched batch.  The 16 requests are a smoke reading of the engine,
   not a throughput metric: the forward alone at batch 32 is timed for
   that;
5. the same shapes for the merged backward, in f32 and bf16 with random
   O(1) dy, ds1, ds2: hold the backward kernel's dx, dW, da, db to
   ``matmul_bn_act_bwd_plain``, show that dropping either cotangent term
   of dyt would move that check far past its limit, and time the kernel, the plain version and
   a library yardstick (two ``torch.matmul`` with the elementwise work as
   torch ops);
6. train full-width ResNet-50 in f32 at batch 32 for 3 steps of
   ``Trainer.fit_batch`` (``Nesterovs(TRAIN_LR, 0.9)``) through the
   kernels, then 3 steps from the same start with both plain versions in
   their place: every step launches each kernel 36 times, step 0's loss
   and every param's step-0 update (its gradient, scaled) agree with the
   plain run, and so do the later losses;
7. the headline training configuration: bf16 policy, batch 256,
   ``Nesterovs(0.1, 0.9)``, a few timed steps (a smaller power-of-two
   batch, said so, if 256 does not fit the card); then phases 3 and 5
   again, in bf16, at every distinct shape of the headline's batch;
8. flash attention at BERT-base's attention shape (B, H, T, D) = (2, 12,
   4096, 64), in f32 and bf16: no mask; a key mask with valid lengths 4096
   and 2500; causal at offsets (1024, 512); Tq = 1000 against Tk = 4096; a
   batch row whose mask is all zeros (dead rows).  Both kernels are held to
   their plain versions (o, m, l; the normalized output and lse; dq, dk, dv
   with O(1) cotangents), a planted fault (the lse shift or delta dropped)
   must move the check far past its limit, and each is timed against the
   plain version and ``scaled_dot_product_attention`` (forward and autograd
   backward, a yardstick only);
9. serve 12-layer BERT-base MLM at seq 4096 (``BertConfig.base()``,
   ``max_position=4096``, ``use_flash=None``, seeded weights) through
   ``predict_mlm`` on 2 x 4096 seeded ids, under the f32 and the bf16
   policy: 12 forward flash launches per call, the kernel path against
   the plain path in log-softmax, and a seq-512 call that takes the einsum
   path (no launch);
10. fine-tune ``bench.py``'s long-sequence configuration (4 layers of
   BERT-base, seq 4096, batch 2, bf16 policy, ``use_flash=True``,
   ``Adam(2e-5)``, its seeded ids, labels and weights) through
   ``BertForMaskedLM.fit``: one warm-up step, then 3 timed steps, each with
   4 forward and 4 backward flash launches; peak memory;
11. the same fine-tune in f32 through the kernels and through both plain
   versions from one set of weights and the same dropout masks: step-0
   loss, every param's step-0 update and the later losses agree;
12. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

f32 means full f32 here: TF32 is switched off for cuBLAS and cuDNN
(``allow_tf32 = False``) for the whole run, so the plain versions and the
convolutions around the kernel compute in f32 as the JAX package's
HIGHEST precision does.  The per-shape tables go to
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
# backward kernel vs plain, max |diff| over max |plain| per output, with dy,
# ds1, ds2 all O(1) (as a train-mode BN's cotangents are).  f32: sum order
# only (read at most 1.9e-6 on the H100); bf16: dx and dW round to bf16
# (2^-8 relative; read at most 4.0e-3 at batch 32, 6.6e-3 at the headline's
# batch 256), da/db are f32 sums (read 2.4e-6).
TOL_BWD = {"float32": {"dx": 2e-5, "dw": 2e-5, "da": 2e-5, "db": 2e-5},
           "bfloat16": {"dx": 1.6e-2, "dw": 1.6e-2, "da": 2e-5, "db": 2e-5}}
# the check must see a fault in dyt = dy + ds1 + 2*y*ds2: with either term
# dropped, the plain backward's dx and dW move by this many times their limit
BWD_FAULT_MARGIN = 10
TRAIN_LR = 0.003       # f32 check: three steps stay finite and O(1)
TRAIN_STEPS = 3
# training through the kernels vs through the plain versions, same start,
# as read on the H100: step 0's loss, relative (read 9.4e-8); every param's
# step-0 update, max over params of |u_kernel - u_plain| / |u_plain| in norm
# (read 3.5e-2, median 2.5e-2: the train-mode BN backward amplifies sum-order
# rounding block over block, as f32 against f64 does on the CPU; a wiring
# fault of the backward reads above 100, tests/test_torch_resnet50_train.py);
# the later losses, relative (read 6.7e-4 at step 2: the two runs' updates
# differ by ~2.5%, so their losses drift apart by ~2.5% of the loss's change)
TRAIN_LOSS0_TOL = 1e-5
TRAIN_UPDATE_TOL = 0.25
TRAIN_LOSS_TOL = 5e-3
HEADLINE_BATCH = 256   # bench.py's ResNet-50 training configuration
HEADLINE_STEPS = 3


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


def check_kernels(calls, dtypes) -> list[dict]:
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for dtype in dtypes:
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
    """Sums over the 36 launches of one batch-32 forward (or backward)."""
    sel = [r for r in rows if r["dtype"] == dname]
    tot = {key: sum(r[key] * r["count"] for r in sel)
           for key in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
    tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in sel)
    return tot


def build_net(updater=None):
    """Full-width ResNet-50 with seeded weights.  The residual-branch BN
    gammas are damped (x0.3, as in the CPU tests) so that 16 blocks of
    random weights keep activations O(1) and the softmax unsaturated:
    otherwise every comparison below would compare one-hot vectors."""
    from deeplearning4j_tpu_torch.models import resnet50
    return damp_residual_gammas(resnet50(fused=True, device="cuda",
                                         updater=updater).init(seed=SEED))


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


class _PlainMatmulBnAct:
    """Comparison only, never on the port's path: ``matmul_bn_act`` with the
    plain forward and the plain backward, whatever the device."""

    def __init__(self):
        import torch
        from deeplearning4j_tpu_torch.ops.kernels import conv_bn

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, w, a, b, relu_in):
                y, s1, s2 = conv_bn.matmul_bn_act_plain(x, w, a, b, relu_in=relu_in)
                ctx.save_for_backward(x, w, a, b, y)
                ctx.relu_in = relu_in
                return y, s1, s2

            @staticmethod
            def backward(ctx, dy, ds1, ds2):
                x, w, a, b, y = ctx.saved_tensors
                return conv_bn.matmul_bn_act_bwd_plain(x, w, a, b, y, dy, ds1, ds2,
                                                       relu_in=ctx.relu_in) + (None,)

        self.fn = Fn

    def __call__(self, x, w, a=None, b=None, *, relu_in: bool = True):
        return self.fn.apply(x, w, a, b, relu_in)


def library_matmul_bn_act_bwd(x, w, a, b, y, dy, ds1, ds2):
    """Yardstick only, never on the port's path: the backward as two
    ``torch.matmul`` in x's dtype (cuBLAS) with the elementwise work and
    the sums as torch ops (relu_in on)."""
    import torch
    dyt = (dy.float() + ds1 + 2.0 * y.float() * ds2).to(dy.dtype)
    dxh = torch.matmul(dyt, w.t())
    da = db = None
    if a is not None:
        xf = x.float()
        pre = xf * a + b
        xh = torch.relu(pre).to(x.dtype)
        dpre = torch.where(pre > 0, dxh.float(), 0.0)
        dx, da, db = (dpre * a).to(x.dtype), (dpre * xf).sum(0), dpre.sum(0)
    else:
        xh, dx = x, dxh
    return dx, torch.matmul(xh.t(), dyt), da, db


def bwd_errs(got, want) -> tuple[dict, float]:
    """Per output of the backward, max |got - want| / max |want|; and the
    largest max |got - want|."""
    errs, abs_err = {}, 0.0
    for name, g, e in zip(("dx", "dw", "da", "db"), got, want):
        if e is None:
            if g is not None:
                raise AssertionError(f"backward {name} given without a prologue")
            continue
        diff = (g.float() - e.float()).abs().max().item()
        abs_err = max(abs_err, diff)
        errs[name] = diff / e.float().abs().max().item()
    return errs, abs_err


def check_bwd_kernels(calls, dtypes) -> list[dict]:
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for dtype in dtypes:
        dname = str(dtype).split(".")[1]
        for (m, k, n, pro) in sorted(set(calls)):
            # as in the net: a call without a prologue reads a ReLU's output
            x = torch.randn(m, k, device="cuda", generator=gen)
            x = (x if pro else x.relu()).to(dtype)
            w = (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5).to(dtype)
            a = torch.rand(k, device="cuda", generator=gen) + 0.5 if pro else None
            b = torch.randn(k, device="cuda", generator=gen) * 0.2 if pro else None
            y = conv_bn.matmul_bn_act_plain(x, w, a, b, relu_in=True)[0]
            dy = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
            # 2*y*ds2 is O(1) beside dy: y is O(1) here
            ds1 = torch.randn(n, device="cuda", generator=gen)
            ds2 = torch.randn(n, device="cuda", generator=gen) * 0.5
            args = (x, w, a, b, y, dy, ds1, ds2)
            got = conv_bn.matmul_bn_act_bwd(*args, relu_in=True)
            torch.cuda.synchronize()
            want = conv_bn.matmul_bn_act_bwd_plain(*args, relu_in=True)
            errs, abs_err = bwd_errs(got, want)
            bad = {key: v for key, v in errs.items() if not v <= TOL_BWD[dname][key]}
            if bad:
                raise AssertionError(f"matmul_bn_act backward {dname} M={m} K={k} N={n} "
                                     f"prologue={pro}: errors {bad} over {TOL_BWD[dname]}")
            fault_errs = {}
            for term, fargs in (("ds1", (x, w, a, b, y, dy, torch.zeros_like(ds1), ds2)),
                                ("2*y*ds2", (x, w, a, b, y, dy, ds1, torch.zeros_like(ds2)))):
                moved = bwd_errs(conv_bn.matmul_bn_act_bwd_plain(*fargs, relu_in=True), want)[0]
                for key in ("dx", "dw"):
                    fault_errs[f"{term} dropped: {key}"] = moved[key] / TOL_BWD[dname][key]
            weak = {key: v for key, v in fault_errs.items() if not v >= BWD_FAULT_MARGIN}
            if weak:
                raise AssertionError(f"matmul_bn_act backward {dname} M={m} K={k} N={n}: "
                                     f"a dropped dyt term moves the check by only {weak} "
                                     f"times its limit")
            isz = x.element_size()
            nbytes = ((2 * m * k + 2 * m * n + 2 * k * n) * isz
                      + (4 * k * 4 if pro else 0) + 2 * n * 4)
            flops = 4 * m * k * n
            row = {"dtype": dname, "M": m, "K": k, "N": n, "prologue": pro,
                   "count": calls.count((m, k, n, pro)), "max_abs_err": abs_err,
                   "rel_err": errs, "fault_over_limit_min": min(fault_errs.values()),
                   "ms": cuda_ms(lambda: conv_bn.matmul_bn_act_bwd(*args, relu_in=True)),
                   "plain_ms": cuda_ms(lambda: conv_bn.matmul_bn_act_bwd_plain(*args,
                                                                               relu_in=True)),
                   "library_ms": cuda_ms(lambda: library_matmul_bn_act_bwd(*args)),
                   "bytes_ms": nbytes / PEAK_BYTES * 1e3,
                   "ops_ms": flops / PEAK_FLOPS[dname] * 1e3}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            rows.append(row)
            log(f"  {dname:8s} M={m:6d} K={k:4d} N={n:4d} pro={int(pro)} x{row['count']}: "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
                f"library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"({'bytes' if row['bytes_ms'] >= row['ops_ms'] else 'operations'}), rel err "
                + " ".join(f"{key} {v:.2e}" for key, v in errs.items())
                + f"; a dropped dyt term reads >= {row['fault_over_limit_min']:.0f}x the limit")
            del x, w, y, dy, got, want
    return rows


def train_steps(net, batch, steps: int) -> dict:
    """``steps`` steps of ``Trainer(net).fit_batch``, each driven with the
    launch counts set to 0 just before it and read just after; returns the
    losses, each step's counts and seconds (synchronized), and the step-0
    update of every param."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    from deeplearning4j_tpu_torch.train import Trainer
    trainer = Trainer(net)
    p0 = {v: {k: t.clone() for k, t in d.items()} for v, d in net.params_.items()}
    out = {"losses": [], "launches": [], "seconds": []}
    for step in range(steps):
        conv_bn.launches = conv_bn.bwd_launches = 0
        if net.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.fit_batch(batch)
        out["losses"].append(loss.item())   # waits for the step
        out["seconds"].append(time.perf_counter() - t0)
        out["launches"].append((conv_bn.launches, conv_bn.bwd_launches))
        if step == 0:
            out["update0"] = {v: {k: net.params_[v][k] - t for k, t in d.items()}
                              for v, d in p0.items()}
    return out


def update_errs(got: dict, want: dict) -> dict:
    """Per param, |u_got - u_want| / |u_want| in norm: the relative error
    of that param's gradient (same learning rate and momentum)."""
    return {f"{v}.{k}": ((u - want[v][k]).norm() / want[v][k].norm()).item()
            for v, d in got.items() for k, u in d.items()}


def train_check(card: str) -> dict:
    """Phase 6: full-width f32 training, kernels vs plain versions."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn.layers import fused as fused_mod
    from deeplearning4j_tpu_torch.train import Nesterovs

    rng = np.random.default_rng(SEED + 3)
    batch = DataSet(torch.from_numpy(rng.normal(size=(BATCH, 224, 224, 3)).astype(np.float32))
                    .cuda(), torch.eye(1000, device="cuda")[rng.integers(0, 1000, BATCH)])
    kernel = train_steps(build_net(Nesterovs(TRAIN_LR, 0.9)), batch, TRAIN_STEPS)
    saved = fused_mod.matmul_bn_act
    fused_mod.matmul_bn_act = _PlainMatmulBnAct()   # comparison only
    try:
        plain = train_steps(build_net(Nesterovs(TRAIN_LR, 0.9)), batch, TRAIN_STEPS)
    finally:
        fused_mod.matmul_bn_act = saved
    if any(c != (36, 36) for c in kernel["launches"]):
        raise AssertionError(f"training launched (forward, backward) kernels "
                             f"{kernel['launches']} per step, not (36, 36)")
    if any(c != (0, 0) for c in plain["launches"]):
        raise AssertionError("the plain run launched a kernel")
    if not all(np.isfinite(kernel["losses"] + plain["losses"])):
        raise AssertionError(f"non-finite loss: {kernel['losses']} vs {plain['losses']}")
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(kernel["losses"], plain["losses"])]
    if not loss_errs[0] <= TRAIN_LOSS0_TOL:
        raise AssertionError(f"step-0 loss {kernel['losses'][0]} vs plain "
                             f"{plain['losses'][0]}: {loss_errs[0]:.2e} relative")
    if not max(loss_errs[1:]) <= TRAIN_LOSS_TOL:
        raise AssertionError(f"later losses {kernel['losses']} vs plain {plain['losses']}")
    errs = update_errs(kernel["update0"], plain["update0"])
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    if not worst[0][1] <= TRAIN_UPDATE_TOL:
        raise AssertionError(f"step-0 updates differ from the plain run's: {worst[:5]}")
    step_s = float(np.mean(kernel["seconds"][1:]))
    plain_step_s = float(np.mean(plain["seconds"][1:]))
    result = {"card": card, "batch": BATCH, "lr": TRAIN_LR, "losses": kernel["losses"],
              "plain_losses": plain["losses"], "loss_rel_errs": loss_errs,
              "launches_per_step": kernel["launches"],
              "update_rel_err_max": worst[0][1], "update_rel_err_worst": worst[:5],
              "update_rel_err_median": float(np.median(list(errs.values()))),
              "step_ms": step_s * 1e3, "plain_step_ms": plain_step_s * 1e3,
              "images_per_s": BATCH / step_s}
    log(f"train f32 batch {BATCH} on {card}: losses {kernel['losses']} "
        f"(plain {plain['losses']}), step-0 loss rel err {loss_errs[0]:.2e}, "
        f"update rel err max {worst[0][1]:.2e} ({worst[0][0]}), median "
        f"{result['update_rel_err_median']:.2e}; (forward, backward) launches per step "
        f"{kernel['launches']}; step {result['step_ms']:.1f} ms "
        f"({result['images_per_s']:.1f} images/s), plain {result['plain_step_ms']:.1f} ms")
    return result


def headline(card: str) -> dict:
    """Phase 7: bf16 policy, batch 256 (or the largest power of two that
    fits), Nesterovs(0.1, 0.9): timed steps after one warm-up step."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.train import Nesterovs

    rng = np.random.default_rng(SEED + 4)
    config.set_dtype_policy(config.DTypePolicy.bf16())
    try:
        batch_size, run = HEADLINE_BATCH, None
        while run is None:
            torch.cuda.reset_peak_memory_stats()
            try:
                batch = DataSet(torch.from_numpy(rng.normal(size=(batch_size, 224, 224, 3))
                                                 .astype(np.float32)).cuda(),
                                torch.eye(1000, device="cuda")[rng.integers(0, 1000,
                                                                            batch_size)])
                run = train_steps(build_net(Nesterovs(0.1, 0.9)), batch, 1 + HEADLINE_STEPS)
            except torch.cuda.OutOfMemoryError:
                if batch_size == 1:
                    raise
            if run is None:   # out of the handler, so the failed step's tensors are gone
                batch = None
                torch.cuda.empty_cache()
                log(f"headline: batch {batch_size} does not fit the card; halving")
                batch_size //= 2
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    if any(c != (36, 36) for c in run["launches"]):
        raise AssertionError(f"headline launched {run['launches']} per step, not (36, 36)")
    if not np.isfinite(run["losses"][0]):
        raise AssertionError(f"headline step-0 loss {run['losses'][0]}")
    step_s = float(np.mean(run["seconds"][1:]))
    result = {"card": card, "policy": "bf16", "batch": batch_size,
              "batch_is_headline": batch_size == HEADLINE_BATCH, "updater": "nesterovs(0.1, 0.9)",
              "losses": run["losses"], "step_ms": step_s * 1e3,
              "images_per_s": batch_size / step_s,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"headline train bf16 batch {batch_size} on {card}: step {result['step_ms']:.1f} ms "
        f"({result['images_per_s']:.1f} images/s) over {HEADLINE_STEPS} steps after one "
        f"warm-up, peak memory {result['peak_memory_gib']:.1f} GiB, losses {run['losses']}")
    return result


# ------------------------------------------------------------------ BERT
FLASH_SEED = SEED + 10
# (name, B, H, Tq, Tk, causal, key-mask valid lengths or None, q_offset, k_offset)
FLASH_CASES = (
    ("base", 2, 12, 4096, 4096, False, None, 0, 0),
    ("key_mask", 2, 12, 4096, 4096, False, (4096, 2500), 0, 0),
    ("causal_offsets", 2, 12, 4096, 4096, True, None, 1024, 512),
    ("cross", 2, 12, 1000, 4096, False, None, 0, 0),
    ("dead_rows", 2, 12, 4096, 4096, False, (4096, 0), 0, 0),
)
# flash kernel vs plain on the same inputs, max |diff| over the largest
# |plain| of each output (m and lse over live rows); dead rows must be
# exactly o = 0, m = NEG_INF, l = 0.  f32: sum order only (read at most
# 3.1e-6 over the five cases on the H100); bf16: p is rounded to bf16
# against the running max in the kernel and against the final max in the
# plain version (o read 2.3e-3), out is bf16 itself (one ulp is 3.9e-3 of
# the largest entry; read 5.8e-3), p and ds round to bf16 before the
# backward's products (read 1.3e-3).
FLASH_TOL = {"float32": {"o": 2e-5, "m": 1e-5, "l": 1e-5, "out": 2e-5, "lse": 1e-5,
                         "dq": 2e-5, "dk": 2e-5, "dv": 2e-5},
             "bfloat16": {"o": 1e-2, "m": 1e-5, "l": 1e-5, "out": 1.6e-2, "lse": 1e-5,
                          "dq": 1e-2, "dk": 1e-2, "dv": 1e-2}}
# the check must see a fault: with the lse shift dropped from p, the plain
# backward's dq, dk and dv move by at least this many times their limits;
# with delta dropped from ds, dq and dk do in f32 (in bf16 a dropped delta
# moves dq by a few percent, within reach of the bf16 limit: it is read,
# not gated)
FLASH_FAULT_MARGIN = 10
BERT_SEQ, BERT_BATCH = 4096, 2
# serving through the kernels vs through the plain versions, max |diff| of
# log-softmax over the 30522-word vocab, 12 layers at seq 4096, as read on
# the H100: f32 4.8e-6 (sum order); bf16 2.5e-2 (the two attentions'
# bf16 roundings differ, and 12 bf16 layers carry the difference on)
BERT_SERVE_TOL = {"float32": 5e-5, "bfloat16": 1e-1}
BERT_TRAIN_LAYERS, BERT_TRAIN_LR, BERT_TRAIN_STEPS = 4, 2e-5, 3
# fine-tuning through the kernels vs through the plain versions, f32, TF32
# off, one start, the same dropout masks, as read on the H100: step-0 loss
# relative (read 9.1e-8); every param's step-0 update, |u_kernel - u_plain|
# / |u_plain| in norm (read at most 3.2e-4, median 5.9e-6; Adam's first
# update is -lr g/(|g|+eps), which keeps each gradient's sign); later
# losses relative (read 0).  The attention key biases are left out of the
# update check: softmax is shift-invariant in each row's scores, so their
# gradient is exactly zero and their Adam updates are rounding noise in
# both runs; they are held to |u| <= lr.
BERT_LOSS0_TOL, BERT_UPDATE_TOL, BERT_LOSS_TOL = 1e-5, 5e-3, 1e-5


def flash_inputs(case, dtype, gen):
    import torch
    name, b, h, tq, tk, causal, lengths, qo, ko = case
    q = torch.randn(b, h, tq, 64, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, h, tk, 64, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, h, tk, 64, device="cuda", generator=gen).to(dtype)
    dout = torch.randn(b, h, tq, 64, device="cuda", generator=gen).to(dtype)
    mask = None
    if lengths is not None:
        mask = (torch.arange(tk, device="cuda")[None, :]
                < torch.tensor(lengths, device="cuda")[:, None]).float()
    return q, k, v, dout, mask, dict(scale=0.125, causal=causal, key_mask=mask, q_offset=qo,
                                     k_offset=ko)


def rel_max(got, want, rows=None) -> float:
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    if want.numel() == 0:
        return 0.0
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def library_attention(q, k, v, kw):
    """Yardstick only, never on the port's path: PyTorch's fused
    scaled_dot_product_attention with the same visibility as a bool mask."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    mask = None
    if kw["key_mask"] is not None or kw["causal"]:
        mask = fa._visible(q.shape[0], q.shape[2], k.shape[2], q.device, kw["causal"],
                           kw["key_mask"], kw["q_offset"], kw["k_offset"])
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=kw["scale"])


def check_flash(dtypes) -> list[dict]:
    """Both flash kernels against their plain versions at every case, in
    each dtype, with a planted fault; times the kernel, the plain version
    and the library yardstick."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(FLASH_SEED)
    rows = []
    for dtype in dtypes:
        dname = str(dtype).split(".")[1]
        tol = FLASH_TOL[dname]
        for case in FLASH_CASES:
            name, b, h, tq, tk = case[:5]
            q, k, v, dout, mask, kw = flash_inputs(case, dtype, gen)
            o, m, l = fa.flash_attention_block(q, k, v, **kw)
            torch.cuda.synchronize()
            oe, me, le = fa.flash_attention_block_plain(q, k, v, **kw)
            dead, live = le == 0, le > 0
            if name == "dead_rows" and not dead.any():
                raise AssertionError("flash dead_rows case has no dead row")
            if not (bool((o[dead] == 0).all()) and bool((l[dead] == 0).all())
                    and bool((m[dead] == fa.NEG_INF).all()) and bool((l[live] > 0).all())):
                raise AssertionError(f"flash {dname} {name}: dead rows are not o=0, m=NEG_INF, l=0")
            errs = {"o": rel_max(o, oe), "m": rel_max(m, me, live), "l": rel_max(l, le)}
            out, lse = fa._forward(q, k, v, mask, kw["scale"], kw["causal"], kw["q_offset"],
                                   kw["k_offset"], normalize=True)
            oute = (oe / torch.clamp(le[..., None], min=1e-20)).to(dtype)
            lsee = fa.flash_lse(me, le)
            errs |= {"out": rel_max(out, oute), "lse": rel_max(lse, lsee, live)}
            del o, m, l, oe, me, le
            got = fa.flash_attention_block_bwd(q, k, v, oute, lsee, dout, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_block_bwd_plain(q, k, v, oute, lsee, dout, **kw)
            for key, g, w in zip(("dq", "dk", "dv"), got, want):
                errs[key] = rel_max(g, w)
            bad = {key: e for key, e in errs.items() if not e <= tol[key]}
            if bad:
                raise AssertionError(f"flash {dname} {name}: errors {bad} over {tol}")
            # planted faults: the lse shift dropped (lse = 0), delta dropped (out = 0)
            faults = {}
            for fault, fargs in (("lse", (oute, torch.zeros_like(lsee))),
                                 ("delta", (torch.zeros_like(oute), lsee))):
                moved = fa.flash_attention_block_bwd_plain(q, k, v, *fargs, dout, **kw)
                for key, g, w in zip(("dq", "dk", "dv"), moved, want):
                    faults[f"{fault} dropped: {key}"] = rel_max(g, w) / tol[key]
                del moved
            gated = [v for key, v in faults.items() if key.startswith("lse")
                     or (dname == "float32" and key[-2:] in ("dq", "dk"))]
            if not min(gated) >= FLASH_FAULT_MARGIN:
                raise AssertionError(f"flash {dname} {name}: a planted fault moves the check "
                                     f"by only {faults} times its limit")
            bwd_abs = max((g - w).abs().max().item() for g, w in zip(got, want))
            del got, want
            # the work these inputs need: visible (query, key) pairs
            vis = fa._visible(b, tq, tk, q.device, kw["causal"], mask, kw["q_offset"],
                              kw["k_offset"])
            pairs = int(vis.expand(b, 1, tq, tk).sum().item()) * h
            isz = q.element_size()
            fwd_bytes = (2 * b * h * tq * 64 + 2 * b * h * tk * 64) * isz + b * h * tq * 4 \
                + (b * tk * 4 if mask is not None else 0)
            bwd_bytes = ((3 * b * h * tq * 64 + 2 * b * h * tk * 64) * isz + b * h * tq * 4
                         + (b * h * tq * 64 + 2 * b * h * tk * 64) * 4
                         + (b * tk * 4 if mask is not None else 0))
            args = (q, k, v, mask, kw["scale"], kw["causal"], kw["q_offset"], kw["k_offset"])
            ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            lib_out = library_attention(ql, kl, vl, kw)
            row = {"case": name, "dtype": dname, "B": b, "H": h, "Tq": tq, "Tk": tk, "D": 64,
                   "causal": kw["causal"], "q_offset": kw["q_offset"],
                   "k_offset": kw["k_offset"], "visible_pairs": pairs, "rel_err": errs,
                   "fault_over_limit": faults, "fault_over_limit_min": min(gated),
                   "max_abs_err": (out.float() - oute.float()).abs().max().item(),
                   "bwd_max_abs_err": bwd_abs,
                   "ms": cuda_ms(lambda: fa._forward(*args, normalize=True), reps=5),
                   "plain_ms": cuda_ms(lambda: fa.normalized_plain(*args[:6]), reps=3),
                   "library_ms": cuda_ms(lambda: library_attention(q, k, v, kw), reps=5),
                   "bytes_ms": fwd_bytes / PEAK_BYTES * 1e3,
                   "ops_ms": 4 * 64 * pairs / PEAK_FLOPS[dname] * 1e3,
                   "bwd_ms": cuda_ms(lambda: fa.flash_attention_block_bwd(
                       q, k, v, oute, lsee, dout, **kw), reps=5),
                   "bwd_plain_ms": cuda_ms(lambda: fa.flash_attention_block_bwd_plain(
                       q, k, v, oute, lsee, dout, **kw), reps=3),
                   "bwd_library_ms": cuda_ms(lambda: torch.autograd.grad(
                       lib_out, (ql, kl, vl), dout, retain_graph=True), reps=5),
                   "bwd_bytes_ms": bwd_bytes / PEAK_BYTES * 1e3,
                   "bwd_ops_ms": 10 * 64 * pairs / PEAK_FLOPS[dname] * 1e3}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bwd_bound_ms"] = max(row["bwd_bytes_ms"], row["bwd_ops_ms"])
            rows.append(row)
            log(f"  {dname:8s} {name:14s} B={b} H={h} Tq={tq} Tk={tk}: fwd kernel "
                f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f}, library "
                f"{row['library_ms']:.3f}, bound {row['bound_ms']:.3f}; bwd kernel "
                f"{row['bwd_ms']:.3f} ms, plain {row['bwd_plain_ms']:.3f}, library "
                f"{row['bwd_library_ms']:.3f}, bound {row['bwd_bound_ms']:.3f}; rel err "
                + " ".join(f"{key} {e:.1e}" for key, e in errs.items())
                + f"; a planted fault reads >= {row['fault_over_limit_min']:.0f}x the limit")
            del q, k, v, dout, oute, lsee, ql, kl, vl, lib_out
            torch.cuda.empty_cache()
    return rows


class plain_flash:
    """Comparison only, never on the port's path: inside the ``with``, the
    flash Function runs the plain forward and backward on the card."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        self.fa, self.saved = fa, (fa._forward, fa.flash_attention_block_bwd)
        fa._forward = lambda q, k, v, key_mask, scale, causal, qo, ko, *, normalize: \
            fa.normalized_plain(q, k, v, key_mask, scale, causal)
        fa.flash_attention_block_bwd = fa.flash_attention_block_bwd_plain
        return self

    def __exit__(self, *exc):
        self.fa._forward, self.fa.flash_attention_block_bwd = self.saved


def bert_config(layers: int, **changes):
    from deeplearning4j_tpu_torch.models import BertConfig
    import dataclasses
    return dataclasses.replace(BertConfig.base(), num_layers=layers, max_position=BERT_SEQ,
                               **changes)


def bert_serve(card: str) -> dict:
    """Phase: predict_mlm on 12-layer BERT-base at seq 4096, f32 and bf16
    policy, through the kernels and through the plain versions."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.models import BertForMaskedLM
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa

    model = BertForMaskedLM(bert_config(12, use_flash=None), seed=0, device="cuda")
    ids = np.random.default_rng(SEED + 11).integers(0, model.config.vocab_size,
                                                    (BERT_BATCH, BERT_SEQ))
    result = {"card": card, "batch": BERT_BATCH, "seq": BERT_SEQ, "layers": 12,
              "params": model.num_params()}
    try:
        for policy in ("f32", "bf16"):
            config.set_dtype_policy(getattr(config.DTypePolicy, policy)())
            dname = "float32" if policy == "f32" else "bfloat16"
            model.predict_mlm(ids)                       # warm-up
            torch.cuda.synchronize()
            fa.launches = fa.bwd_launches = 0
            t0 = time.perf_counter()
            logits = model.predict_mlm(ids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fa.launches
            if launches != 12 or fa.bwd_launches:
                raise AssertionError(f"BERT serve {policy}: {launches} forward flash launches "
                                     f"(and {fa.bwd_launches} backward) for one call, not 12")
            if tuple(logits.shape) != (BERT_BATCH, BERT_SEQ, model.config.vocab_size) \
                    or logits.dtype != torch.float32 or not torch.isfinite(logits).all():
                raise AssertionError(f"BERT serve {policy}: logits {tuple(logits.shape)} "
                                     f"{logits.dtype} or non-finite")
            ms = cuda_ms(lambda: model.predict_mlm(ids), reps=3, warmup=0)
            fa.launches = 0
            with plain_flash():
                plain = model.predict_mlm(ids)
                plain_ms = cuda_ms(lambda: model.predict_mlm(ids), reps=2, warmup=0)
            if fa.launches:
                raise AssertionError("the plain serving run launched a flash kernel")
            err = (torch.log_softmax(logits, -1) - torch.log_softmax(plain, -1)).abs().max().item()
            if not err <= BERT_SERVE_TOL[dname]:
                raise AssertionError(f"BERT serve {policy}: kernel vs plain log-softmax differ "
                                     f"by {err} (limit {BERT_SERVE_TOL[dname]})")
            del logits, plain
            fa.launches = 0
            short = model.predict_mlm(ids[:, :512])
            if fa.launches != 0 or tuple(short.shape)[:2] != (BERT_BATCH, 512):
                raise AssertionError(f"BERT serve {policy} at seq 512 launched {fa.launches} "
                                     f"flash kernels (the einsum path takes it)")
            del short
            result[policy] = {"launches": launches, "first_call_s": wall, "ms": ms,
                              "tokens_per_s": BERT_BATCH * BERT_SEQ / ms * 1e3,
                              "plain_ms": plain_ms, "max_log_softmax_err": err}
            log(f"BERT-base serve {policy} on {card}: predict_mlm batch {BERT_BATCH} x "
                f"{BERT_SEQ}, 12 layers: {ms:.1f} ms ({result[policy]['tokens_per_s']:.0f} "
                f"tokens/s), plain {plain_ms:.1f} ms; {launches} flash launches per call; "
                f"kernel vs plain log-softmax {err:.2e}; seq 512: 0 launches")
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    return result


class StepWatch:
    """A ``fit`` listener: per step, the seconds since the last step (host
    clock; ``fit`` reads the loss, which waits for the step), the flash
    launch counts (then set to 0), the loss, and after step 0 each
    param's update against ``p0``."""

    def __init__(self, p0=None):
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        self.fa, self.p0 = fa, p0
        self.seconds, self.launches, self.losses, self.update0 = [], [], [], None
        fa.launches = fa.bwd_launches = 0
        self.t0 = time.perf_counter()

    def iteration_done(self, model, iteration, epoch, score):
        from deeplearning4j_tpu_torch.train.updaters import tree_map
        now = time.perf_counter()
        self.seconds.append(now - self.t0)
        self.launches.append((self.fa.launches, self.fa.bwd_launches))
        self.losses.append(score)
        if iteration == 0 and self.p0 is not None:
            self.update0 = tree_map(lambda p, q: p - q, model.params, self.p0)
        self.fa.launches = self.fa.bwd_launches = 0
        self.t0 = time.perf_counter()


def bert_batch(vocab: int) -> dict:
    """bench.py's long-sequence batch: ids, labels and weights from
    ``default_rng(0)``, an all-ones attention mask."""
    import numpy as np
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (BERT_BATCH, BERT_SEQ))
    labels = rng.integers(0, vocab, (BERT_BATCH, BERT_SEQ))
    weights = (rng.random((BERT_BATCH, BERT_SEQ)) < 0.15).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "label_weights": weights,
            "attention_mask": np.ones((BERT_BATCH, BERT_SEQ), np.float32)}


def bert_finetune(card: str) -> dict:
    """Phase: bench.py's long-sequence fine-tune (4 layers of BERT-base,
    seq 4096, batch 2, bf16 policy, use_flash=True, Adam(2e-5)) through
    ``BertForMaskedLM.fit``: one warm-up step, then timed steps."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.models import BertForMaskedLM
    from deeplearning4j_tpu_torch.train import Adam

    config.set_dtype_policy(config.DTypePolicy.bf16())
    try:
        model = BertForMaskedLM(bert_config(BERT_TRAIN_LAYERS, use_flash=True), seed=0,
                                device="cuda")
        batch = bert_batch(model.config.vocab_size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        watch = StepWatch()
        model.fit([batch] * (1 + BERT_TRAIN_STEPS), updater=Adam(BERT_TRAIN_LR),
                  listeners=[watch])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    if any(c != (BERT_TRAIN_LAYERS, BERT_TRAIN_LAYERS) for c in watch.launches):
        raise AssertionError(f"BERT fine-tune launched (forward, backward) flash kernels "
                             f"{watch.launches} per step, not ({BERT_TRAIN_LAYERS}, "
                             f"{BERT_TRAIN_LAYERS})")
    if not all(np.isfinite(watch.losses)):
        raise AssertionError(f"BERT fine-tune losses {watch.losses}")
    step_s = float(np.mean(watch.seconds[1:]))
    result = {"card": card, "policy": "bf16", "layers": BERT_TRAIN_LAYERS, "seq": BERT_SEQ,
              "batch": BERT_BATCH, "updater": f"adam({BERT_TRAIN_LR})",
              "params": model.num_params(), "losses": watch.losses,
              "launches_per_step": watch.launches, "step_s": watch.seconds,
              "step_ms": step_s * 1e3, "tokens_per_s": BERT_BATCH * BERT_SEQ / step_s,
              "peak_memory_gib": peak}
    log(f"BERT fine-tune bf16 on {card}: {BERT_TRAIN_LAYERS} layers, batch {BERT_BATCH} x "
        f"{BERT_SEQ}: step {result['step_ms']:.1f} ms ({result['tokens_per_s']:.0f} tokens/s) "
        f"over {BERT_TRAIN_STEPS} steps after one warm-up; (forward, backward) flash launches "
        f"per step {watch.launches}; peak memory {peak:.1f} GiB; losses {watch.losses}")
    return result


def bert_train_check(card: str) -> dict:
    """Phase: the fine-tune in f32 (TF32 off) through the kernels and
    through the plain versions, from one set of weights, with the same
    dropout masks (fit seeds its generator from the model's seed)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models import BertForMaskedLM
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.train.updaters import tree_map

    cfg = bert_config(BERT_TRAIN_LAYERS, use_flash=True)
    runs = {}
    for name in ("kernel", "plain"):
        model = BertForMaskedLM(cfg, seed=0, device="cuda")
        batch = bert_batch(cfg.vocab_size)
        watch = StepWatch(tree_map(lambda p: p.clone(), model.params))
        if name == "plain":
            with plain_flash():
                model.fit([batch] * BERT_TRAIN_STEPS, updater=Adam(BERT_TRAIN_LR),
                          listeners=[watch])
        else:
            model.fit([batch] * BERT_TRAIN_STEPS, updater=Adam(BERT_TRAIN_LR), listeners=[watch])
        runs[name] = watch
        del model
    kernel, plain = runs["kernel"], runs["plain"]
    if any(c != (BERT_TRAIN_LAYERS, BERT_TRAIN_LAYERS) for c in kernel.launches):
        raise AssertionError(f"f32 fine-tune launched {kernel.launches} per step")
    if any(c != (0, 0) for c in plain.launches):
        raise AssertionError("the plain fine-tune launched a flash kernel")
    if not all(np.isfinite(kernel.losses + plain.losses)):
        raise AssertionError(f"non-finite loss: {kernel.losses} vs {plain.losses}")
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(kernel.losses, plain.losses)]
    if not loss_errs[0] <= BERT_LOSS0_TOL:
        raise AssertionError(f"BERT step-0 loss {kernel.losses[0]} vs plain {plain.losses[0]}")
    if not max(loss_errs[1:]) <= BERT_LOSS_TOL:
        raise AssertionError(f"BERT later losses {kernel.losses} vs plain {plain.losses}")
    errs, key_bias = bert_update_errs(kernel.update0, plain.update0)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    if not worst[0][1] <= BERT_UPDATE_TOL:
        raise AssertionError(f"BERT step-0 updates differ from the plain run's: {worst[:5]}")
    if not key_bias <= BERT_TRAIN_LR * (1 + 1e-6):
        raise AssertionError(f"a key bias moved by {key_bias}, past lr {BERT_TRAIN_LR}")
    result = {"card": card, "policy": "f32", "layers": BERT_TRAIN_LAYERS, "losses":
              kernel.losses, "plain_losses": plain.losses, "loss_rel_errs": loss_errs,
              "launches_per_step": kernel.launches, "update_rel_err_max": worst[0][1],
              "update_rel_err_worst": worst[:5],
              "update_rel_err_median": float(np.median(list(errs.values()))),
              "key_bias_update_max": key_bias,
              "step_ms": float(np.mean(kernel.seconds[1:])) * 1e3,
              "plain_step_ms": float(np.mean(plain.seconds[1:])) * 1e3}
    log(f"BERT fine-tune f32 kernel vs plain on {card}: losses {kernel.losses} (plain "
        f"{plain.losses}), step-0 loss rel err {loss_errs[0]:.2e}, update rel err max "
        f"{worst[0][1]:.2e} ({worst[0][0]}), median {result['update_rel_err_median']:.2e}; "
        f"step {result['step_ms']:.1f} ms, plain {result['plain_step_ms']:.1f} ms")
    return result


def bert_update_errs(got: dict, want: dict) -> tuple[dict, float]:
    """Per param but the attention key biases, |u_got - u_want| / |u_want|
    in norm; and the largest |u| of a key bias in either tree."""
    from deeplearning4j_tpu_torch.io.model_serializer import leaf_at, tree_paths
    errs, key_bias = {}, 0.0
    for path in tree_paths(want):
        ug, uw = leaf_at(got, path), leaf_at(want, path)
        if path[-2:] == ("key", "bias"):
            key_bias = max(key_bias, ug.abs().max().item(), uw.abs().max().item())
            continue
        errs["/".join(path)] = ((ug - uw).norm() / uw.norm().clamp_min(1e-30)).item()
    return errs, key_bias


def flash_entry(name, source, replaces, rows, prefix, launches, work) -> dict:
    """The kernels-line entry of one flash kernel (``prefix`` "" for the
    forward, "bwd_" for the backward): f32 figures at the base case, bf16
    ones beside them."""
    def pick(dname):
        r = next(r for r in rows if r["case"] == "base" and r["dtype"] == dname)
        bound = {"bytes": r[f"{prefix}bytes_ms"], "operations": r[f"{prefix}ops_ms"]}
        by = max(bound, key=bound.get)
        return {"ms": r[f"{prefix}ms"], "plain_ms": r[f"{prefix}plain_ms"],
                "bound_ms": bound[by], "bound_by": by, "library_ms": r[f"{prefix}library_ms"],
                "max_abs_err": r[f"{prefix}max_abs_err"]}
    bf16 = pick("bfloat16")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **pick("float32"), "work": work,
            **{f"bf16_{k}": v for k, v in bf16.items()}}


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
    log(f"SMs: {torch.cuda.get_device_properties(0).multi_processor_count}")

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
    rows = check_kernels(calls, (torch.float32, torch.bfloat16))

    serving = serve(net, card)
    del net

    log(f"backward kernel check: {len(set(calls))} distinct shapes, "
        f"{sum(4 * m * k * n for m, k, n, _ in calls) / BATCH / 1e9:.3f} GFLOP per image")
    bwd_rows = check_bwd_kernels(calls, (torch.float32, torch.bfloat16))
    training = train_check(card)
    head = headline(card)
    # the headline ran both kernels at its own shapes: hold them there too
    from deeplearning4j_tpu_torch.models import resnet50
    head_calls = resnet50_calls(resnet50(fused=True, device="cuda"), head["batch"])
    log(f"kernel checks at the headline's batch {head['batch']}, bf16: "
        f"{len(set(head_calls))} distinct shapes")
    head_rows = check_kernels(head_calls, (torch.bfloat16,))
    head_bwd_rows = check_bwd_kernels(head_calls, (torch.bfloat16,))
    torch.cuda.empty_cache()

    log(f"flash attention kernel check: {len(FLASH_CASES)} cases at (B, H, D) = "
        f"({BERT_BATCH}, 12, 64), f32 and bf16")
    flash_rows = check_flash((torch.float32, torch.bfloat16))
    bert_served = bert_serve(card)
    bert_head = bert_finetune(card)
    bert_check = bert_train_check(card)

    def entry(name, source, replaces, tot, tot16, head16, launches, work):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": tot["bound_by"], "library_ms": tot["library_ms"], "work": work,
                "bf16_ms": tot16["ms"], "bf16_plain_ms": tot16["plain_ms"],
                "bf16_bound_ms": tot16["bound_ms"], "bf16_bound_by": tot16["bound_by"],
                "bf16_library_ms": tot16["library_ms"], "bf16_max_abs_err": tot16["max_abs_err"],
                "headline_bf16_ms": head16["ms"], "headline_bf16_max_abs_err": head16["max_abs_err"]}

    f32, bf16 = per_forward(rows, "float32"), per_forward(rows, "bfloat16")
    b32, b16 = per_forward(bwd_rows, "float32"), per_forward(bwd_rows, "bfloat16")
    h16, hb16 = per_forward(head_rows, "bfloat16"), per_forward(head_bwd_rows, "bfloat16")
    train_launches = [sum(c[i] for c in training["launches_per_step"]) for i in (0, 1)]
    work = (f"the 36 calls of one ResNet-50 {{}} at batch {BATCH}, f32 (bf16_*: bf16; "
            f"headline_*: bf16 at batch {head['batch']})")
    flash_launches = [sum(c[i] for c in bert_head["launches_per_step"]) for i in (0, 1)]
    flash_work = (f"one attention call of the BERT-base path, (B, H, T, D) = ({BERT_BATCH}, 12, "
                  f"{BERT_SEQ}, 64), f32 (bf16_*: bf16); launches: the bf16 fine-tune's "
                  f"{1 + BERT_TRAIN_STEPS} steps")
    kernels = [
        entry("matmul_bn_act", "deeplearning4j_tpu_torch/ops/kernels/csrc/matmul_bn_act.cu",
              "deeplearning4j_tpu/ops/pallas/conv_bn.py:58", f32, bf16, h16, train_launches[0],
              work.format("forward")) | {"serve_launches": serving["launches"]},
        entry("matmul_bn_act_bwd",
              "deeplearning4j_tpu_torch/ops/kernels/csrc/matmul_bn_act_bwd.cu",
              "deeplearning4j_tpu/ops/pallas/conv_bn.py:92", b32, b16, hb16, train_launches[1],
              work.format("backward")),
        flash_entry("flash_attention",
                    "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_attention_fwd.cu",
                    "deeplearning4j_tpu/ops/pallas/flash_attention.py:33", flash_rows, "",
                    flash_launches[0], flash_work)
        | {"serve_launches": sum(bert_served[p]["launches"] for p in ("f32", "bf16"))},
        flash_entry("flash_attention_bwd",
                    "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
                    "deeplearning4j_tpu/ops/pallas/flash_attention.py:380", flash_rows, "bwd_",
                    flash_launches[1], flash_work),
    ]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "shapes": rows, "per_forward": {"float32": f32, "bfloat16": bf16},
         "bwd_shapes": bwd_rows, "per_backward": {"float32": b32, "bfloat16": b16},
         "headline_shapes": head_rows, "headline_bwd_shapes": head_bwd_rows,
         "per_headline_step": {"forward": h16, "backward": hb16},
         "serve": serving, "train": training, "headline": head,
         "flash_shapes": flash_rows, "bert_serve": bert_served, "bert_finetune": bert_head,
         "bert_train_check": bert_check, "kernels": kernels,
         "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
