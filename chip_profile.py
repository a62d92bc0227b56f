#!/usr/bin/env python3
"""Where the time of the port's ResNet-50 forward, training step and
frozen fine-tune step, of
its BERT fine-tune steps (bf16 and f32) and seq-128 headline step (by
itself and through ``fit``), of its int8 VGG-16 serving forward and of
the MLP-MNIST, LeNet and UCI-HAR LSTM training steps goes on one CUDA
card, each run
eagerly (``train.capture.eager()``) and as the captured step the port
runs by default (CUDA graphs, ``train/capture.py``).

    python3 chip_profile.py                  # every workload
    python3 chip_profile.py NAME [NAME ...]  # only these (the names below)

Builds the same seeded models as ``chip_smoke.py`` (TF32 off) and, for
each workload and mode, warms it up (the captured mode: two eager calls
and the capture), times it with CUDA events (every workload and mode
before any tracing), reads the host's time over runs of about
``HOST_WINDOW_MS`` in all, each from an idle card (before any tracing
too), and traces ``ITERS`` runs with ``torch.profiler``, back to back
for the device, one at a time for the launch calls:

- ``forward``: ResNet-50's inference forward on ``chip_smoke.BATCH``
  images, f32: ``net.output`` eager, the serving engine's cached forward
  (``serve.engine``) captured;
- ``train_step``: ResNet-50 ``Trainer.fit_batch`` (forward, backward,
  update) at ``chip_smoke.TRAIN_LR``, f32;
- ``resnet50_stats_step``: the same ``fit_batch`` sampled by a
  ``StatsListener`` (``chip_smoke`` phase 27): the statistics step
  (``make_train_step(with_stats=True)``: per-layer statistics and 20-bin
  histograms of the params, gradients and updates), the copy of its
  packed statistics to the host and ``stats_ready``;
- ``resnet50_finetune_frozen``: ``Trainer.fit_batch`` of
  ``chip_smoke.finetune_net`` (stem and res2-res4 frozen, the head on an
  AdamW of its own, both rates scheduled; 5 classes), f32;
- ``bert_finetune_step``: one ``BertForMaskedLM.fit`` step of bench.py's
  long-sequence configuration (4 layers of BERT-base, batch 2 x 4096,
  bf16 policy, flash attention, ``Adam(2e-5)``);
- ``bert_finetune_step_f32``: the same step under the f32 policy (its own
  model and updater), where the flash kernels run three TF32 passes;
- ``bert_headline_step_seq128``: one ``make_train_step`` step of BERT-base
  MLM's seq-128 headline (``bench.py:181-230``: 12 layers, batch 32 x
  128, ``max_predictions=32``, bf16 policy, ``Adam(2e-5,
  mu_dtype="bf16")``; einsum attention, no kernel of this repo);
- ``bert_headline_fit_seq128``: ``FIT_STEPS`` steps of the same through
  ``BertForMaskedLM.fit`` (its ``DeviceFeeder`` thread and listener bus;
  ``fit`` reads every step's loss, so the host waits for the card);
- ``vgg16_int8_forward``: VGG-16 quantized by ``quantize_net``, on
  ``chip_smoke.VGG_BATCH`` images under the bf16 serving policy (bf16
  params, compute and outputs), its three dense layers through the int8
  kernel and its convolutions' weights widened on read (``qnet.output``
  eager, the engine's cached forward captured);
- ``mlp_mnist_step`` and ``lenet_cifar10_step``: ``Trainer.fit_batch`` of
  ``mlp_mnist()`` and of ``lenet(32, 32, 3)`` at batch 128 (f32), on
  ``bench.py``'s ``bench_workload_steps`` data (``chip_smoke.small_nets``);
- ``lstm_har_step``: ``Trainer.fit_batch`` of ``lstm_classifier()`` at
  batch 64 x 128 x 9 (f32), the same stream's next arrays
  (``chip_smoke.har_batches``, ``bench.py:499-502``);
- ``resnet50_two_slice_step``: one ``MultiSliceTrainer.fit_batch`` of
  ``chip_smoke`` phase 26's configuration (ResNet-50 f32 across 2 slices
  x batch 16 on the one card, ``Sgd(0.01)``, the device codec,
  synchronous): both slices' gradient, residual and encode steps, the
  exchange and both decode-and-apply steps.

Prints the card's name and power limit and, per workload and mode, its
wall time from CUDA events; the host side, each run from an idle card:
the time until the call returns and the CPU time of all threads
meanwhile (``time.process_time``), the feeder thread's share
(``time.thread_time`` at the end of each of its staging calls), the
number of kernel launches (``cudaLaunchKernel``, ``cuLaunchKernel``) and
of graph launches (``cudaGraphLaunch``) and the time in them (traced),
and the rest of the CPU time (Python, PyTorch's dispatch, the autograd
engine, and the waits of a call that reads its loss); the kernels and
copies it runs on the device per run,
the device time per category of kernel (this repo's
``matmul_bn_act``, flash attention and int8 kernels, convolutions,
matmuls, softmax, the codec's top-k and sorts, elementwise, copies and
casts, pooling and reductions, other) per run,
the busy share of the device over the traced window, and the 15 kernels
with the most device time.  Writes the same to
``chiprun_out/chip_profile.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import sys
import threading
import time

import chip_smoke

ITERS = 5
# runs for the host's time: enough for about this many ms (the process
# and thread CPU clocks may tick as coarsely as every 10 ms)
HOST_WINDOW_MS = 3000
FIT_STEPS = 5           # steps of the headline through fit per run

CATEGORIES = (
    ("conv3x3_bn_act", ("c3_f32_kernel", "c3_bf16_kernel")),
    ("int8_matmul", ("i8_f32_kernel", "i8_bf16_kernel")),
    ("matmul_bn_act", ("mbf_f32_kernel", "mbf_bf16_kernel", "mbf_wt_kernel")),
    ("matmul_bn_act_bwd", ("mbb_dx_f32_kernel", "mbb_dw_f32_kernel", "mbb_dx_bf16_kernel",
                           "mbb_dw_bf16_kernel")),
    ("flash_attention", ("fa_fwd_f32_kernel", "fa_fwd_bf16_kernel")),
    ("flash_attention_bwd", ("fa_bwd_f32_kernel", "fa_bwd_bf16_kernel")),
    ("flash_attention_bwd_split", ("fa_dq_f32_kernel", "fa_dq_bf16_kernel", "fa_dkv_f32_kernel",
                                   "fa_dkv_bf16_kernel")),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft")),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90", "nvjet")),
    ("softmax", ("softmax",)),
    ("topk_sort", ("mbtopk", "radixsort")),
    ("copy", ("memcpy", "copy", "memset")),
    ("pooling", ("pool",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def profile(card: str, name: str, fn, run_ms: float, items: int, unit: str,
            host: dict) -> dict:
    """Trace ITERS runs of ``fn`` (warm already, timed at ``run_ms``, its
    host CPU time read as ``host``), each of ``items`` images or tokens
    (``unit``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    kernels, launches = {}, 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us and getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + dev_us / 1e3 / ITERS
            launches += evt.count
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    by_cat: dict[str, float] = {}
    for kname, ms in kernels.items():
        by_cat[category(kname)] = by_cat.get(category(kname), 0.0) + ms
    device_ms = sum(kernels.values())
    api_ms = host["kernel_launch_api_ms"] + host["graph_launch_api_ms"]
    result = {"workload": name, "card": card, "items": items, "unit": unit, "iters": ITERS,
              "ms": run_ms, f"{unit}_per_s": items / run_ms * 1e3,
              "device_ms": device_ms, "busy_share": device_ms * ITERS / window_ms,
              "device_ops_per_run": launches / ITERS, **host,
              "rest_of_host_cpu_ms": host["cpu_ms"] - host["feeder_cpu_ms"] - api_ms,
              "categories_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
              "top_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15])}
    print(f"{name}, {items} {unit} on {card}: {run_ms:.3f} ms "
          f"({result[f'{unit}_per_s']:.1f} {unit}/s); device time {device_ms:.3f} ms "
          f"per run in {result['device_ops_per_run']:.0f} kernels and copies, busy "
          f"{result['busy_share']:.1%} of the traced window")
    print(f"  host, from an idle card: {host['host_ms']:.3f} ms a run until it returns, CPU "
          f"{host['cpu_ms']:.3f} ms (all threads; the feeder {host['feeder_cpu_ms']:.3f}); "
          f"traced: {host['kernel_launches']:.0f} kernel launches "
          f"({host['kernel_launch_api_ms']:.3f} ms) and {host['graph_launches']:.0f} graph "
          f"launches ({host['graph_launch_api_ms']:.3f} ms); the rest of the CPU time (Python, "
          f"dispatch, autograd, waits) {result['rest_of_host_cpu_ms']:.3f} ms")
    for cat, ms in result["categories_ms"].items():
        print(f"  {cat:18s} {ms:8.3f} ms  {ms / device_ms:6.1%}")
    for kname, ms in result["top_kernels_ms"].items():
        print(f"  {ms:8.3f} ms  {kname[:110]}")
    return result


class FeederClock:
    """While open, keeps the CPU time of every ``DeviceFeeder`` producer
    thread as of the end of its last staging call (``time.thread_time``
    read in that thread), summed by ``seconds()``."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.data.device_pipeline import DeviceFeeder
        self.cls, self.stage, self.by_thread = DeviceFeeder, DeviceFeeder.stage, {}
        stage = self.stage

        def timed(feeder, batch):
            out = stage(feeder, batch)
            self.by_thread[threading.get_ident()] = time.thread_time()
            return out
        DeviceFeeder.stage = timed
        return self

    def seconds(self) -> float:
        return sum(self.by_thread.values())

    def __exit__(self, *exc):
        self.cls.stage = self.stage


def host_time(fn, runs: int) -> dict:
    """``runs`` calls of ``fn`` (warm already), each from an idle card, so
    that nothing waits on a full launch queue: per run the wall time until
    the call returns (the host's work before the card has it all) and the
    CPU time of all threads meanwhile (the process clock), and the feeder
    threads' CPU time (their whole life: each feeds one ``fit`` call)."""
    import torch
    wall = cpu = 0.0
    with FeederClock() as clock:
        for _ in range(runs):
            torch.cuda.synchronize()
            cpu0, t0 = time.process_time(), time.perf_counter()
            fn()
            wall += time.perf_counter() - t0
            cpu += time.process_time() - cpu0
        torch.cuda.synchronize()
    return {"host_ms": wall / runs * 1e3, "cpu_ms": cpu / runs * 1e3,
            "feeder_cpu_ms": clock.seconds() / runs * 1e3, "host_runs": runs}


def launch_api(fn) -> dict:
    """``ITERS`` calls of ``fn`` traced, each from an idle card: the kernel
    launches and graph launches the host made per call and the time it
    spent in them (CUPTI's callbacks lengthen each call: an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            torch.cuda.synchronize()
            fn()
        torch.cuda.synchronize()
    api = {"kernel_launches": 0, "kernel_launch_api_ms": 0.0, "graph_launches": 0,
           "graph_launch_api_ms": 0.0}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
            continue
        kind = ("graph" if chip_smoke.GRAPH_LAUNCH_API in evt.key else
                "kernel" if chip_smoke.KERNEL_LAUNCH_API in evt.key else None)
        if kind:
            api[f"{kind}_launches"] += evt.count / ITERS
            api[f"{kind}_launch_api_ms"] += evt.cpu_time_total / 1e3 / ITERS
    return api


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import (BertForMaskedLM, lenet, lstm_classifier,
                                                 mlp_mnist, vgg16)
    from deeplearning4j_tpu_torch.nn.quantize import quantize_net
    from deeplearning4j_tpu_torch.obs.stats import InMemoryStatsStorage, StatsListener
    from deeplearning4j_tpu_torch.parallel import AdaptiveThresholdAlgorithm, MultiSliceTrainer
    from deeplearning4j_tpu_torch.serve.engine import _build_forward
    from deeplearning4j_tpu_torch.train import Adam, Nesterovs, Sgd, Trainer, capture
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)

    net = chip_smoke.build_net(Nesterovs(chip_smoke.TRAIN_LR, 0.9))
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    x = torch.randn(chip_smoke.BATCH, 224, 224, 3, device="cuda", generator=gen)
    labels = torch.eye(1000, device="cuda")[torch.randint(0, 1000, (chip_smoke.BATCH,),
                                                          device="cuda", generator=gen)]
    trainer, batch = Trainer(net), DataSet(x, labels)
    stats_trainer = Trainer(net, listeners=[StatsListener(InMemoryStatsStorage(), frequency=1)])
    ft_trainer = Trainer(chip_smoke.finetune_net(net))     # its own step: frozen layers
    ft_batch = DataSet(x, torch.eye(chip_smoke.FT_CLASSES, device="cuda")[torch.randint(
        0, chip_smoke.FT_CLASSES, (chip_smoke.BATCH,), device="cuda", generator=gen)])
    bert = BertForMaskedLM(chip_smoke.bert_config(chip_smoke.BERT_TRAIN_LAYERS, use_flash=True),
                           seed=0, device="cuda")
    bert_batch = chip_smoke.bert_batch(bert.config.vocab_size)
    adam = Adam(chip_smoke.BERT_TRAIN_LR)
    bert32 = BertForMaskedLM(chip_smoke.bert_config(chip_smoke.BERT_TRAIN_LAYERS, use_flash=True),
                             seed=0, device="cuda")
    adam32 = Adam(chip_smoke.BERT_TRAIN_LR)
    tokens = chip_smoke.BERT_BATCH * chip_smoke.BERT_SEQ
    set_policy = config.set_dtype_policy
    set_policy(config.DTypePolicy.bf16())
    try:       # the seq-128 headline's model, state and batch (chip_smoke phase 20)
        head = BertForMaskedLM(chip_smoke.headline_config(), seed=0, device="cuda")
        head_adam = Adam(chip_smoke.HEADLINE_LR, mu_dtype="bf16")
        head_step = head.make_train_step(head_adam)
        hb = chip_smoke.headline_batch(head.config.vocab_size)
        head_args = [torch.as_tensor(hb[k], device="cuda").to(dt) for k, dt in
                     (("input_ids", torch.long), ("labels", torch.long),
                      ("label_weights", torch.float32), ("attention_mask", torch.float32))]
        head_state = [head.params, head_adam.init(head.params)]
        head_gen = torch.Generator(device="cuda").manual_seed(0)
    finally:
        set_policy(config.DTypePolicy.f32())

    def headline_step():
        head_state[0], head_state[1], loss = head_step(head_state[0], head_state[1],
                                                       *head_args, head_gen)
        return loss
    serving = config.DTypePolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                                 output_dtype=torch.bfloat16)
    f32, bf16 = config.DTypePolicy.f32(), config.DTypePolicy.bf16()

    def in_policy(policy, fn):
        config.set_dtype_policy(policy)
        try:
            return fn()
        finally:
            config.set_dtype_policy(config.DTypePolicy.f32())

    qnet = in_policy(serving,
                     lambda: quantize_net(vgg16(device="cuda").init(seed=chip_smoke.SEED)))
    images = torch.randn(chip_smoke.VGG_BATCH, 224, 224, 3, device="cuda", generator=gen)
    forward, qforward = _build_forward(net), _build_forward(qnet)

    def served(step, model, inputs):
        with torch.inference_mode():
            return step(model.params_, model.state_, inputs, None)
    head_fit = in_policy(bf16, lambda: BertForMaskedLM(chip_smoke.headline_config(), seed=0,
                                                       device="cuda"))
    head_fit_batch = chip_smoke.headline_batch(head_fit.config.vocab_size)
    head_fit_adam = Adam(chip_smoke.HEADLINE_LR, mu_dtype="bf16")
    rng = np.random.default_rng(0)      # bench.py's bench_workload_steps data
    small = {}
    for name, factory, kwargs, shape in (
            ("mlp_mnist_step", mlp_mnist, {}, (784,)),
            ("lenet_cifar10_step", lenet, {"height": 32, "width": 32, "channels": 3},
             (32, 32, 3))):
        features = rng.normal(size=(chip_smoke.SMALL_BATCH,) + shape).astype(np.float32)
        onehot = np.eye(10, dtype=np.float32)[rng.integers(0, 10, chip_smoke.SMALL_BATCH)]
        small[name] = (Trainer(factory(device="cuda", **kwargs).init(seed=chip_smoke.SMALL_SEED)),
                       DataSet(torch.from_numpy(features).cuda(),
                               torch.from_numpy(onehot).cuda()),
                       chip_smoke.SMALL_BATCH, "images")
    har_x, har_y = chip_smoke.har_batches(1)[0]
    small["lstm_har_step"] = (Trainer(lstm_classifier(device="cuda")
                                      .init(seed=chip_smoke.SMALL_SEED)),
                              DataSet(torch.from_numpy(har_x).cuda(),
                                      torch.from_numpy(har_y).cuda()), chip_smoke.HAR_BATCH,
                              "sequences")
    dcn_x, dcn_y = chip_smoke.dcn_batch(chip_smoke.DCN_SLICES * chip_smoke.DCN_BATCH)
    dcn_data = DataSet(torch.from_numpy(dcn_x).cuda(), torch.from_numpy(dcn_y).cuda())
    dcn = MultiSliceTrainer(chip_smoke.build_net(Sgd(chip_smoke.DCN_LR)), chip_smoke.DCN_SLICES,
                            devices=["cuda"] * chip_smoke.DCN_SLICES,
                            algorithm=AdaptiveThresholdAlgorithm(
                                initial_threshold=chip_smoke.DCN_TAU0))
    # name: (eager run, captured run, items per run, unit, dtype policy)
    workloads = {
        "forward": (lambda: net.output(x), lambda: served(forward, net, x), chip_smoke.BATCH,
                    "images", f32),
        "train_step": (lambda: trainer.fit_batch(batch),) * 2 + (chip_smoke.BATCH, "images",
                                                                 f32),
        "resnet50_stats_step": (lambda: stats_trainer.fit_batch(batch),) * 2
        + (chip_smoke.BATCH, "images", f32),
        "resnet50_finetune_frozen": (lambda: ft_trainer.fit_batch(ft_batch),) * 2
        + (chip_smoke.BATCH, "images", f32),
        "bert_finetune_step": (lambda: bert.fit([bert_batch], updater=adam),) * 2
        + (tokens, "tokens", bf16),
        "bert_finetune_step_f32": (lambda: bert32.fit([bert_batch], updater=adam32),) * 2
        + (tokens, "tokens", f32),
        "bert_headline_step_seq128": (headline_step,) * 2 + (chip_smoke.HEADLINE_SEQS
                                                             * chip_smoke.HEADLINE_SEQ, "tokens",
                                                             bf16),
        "bert_headline_fit_seq128": (lambda: head_fit.fit([head_fit_batch] * FIT_STEPS,
                                                          updater=head_fit_adam),) * 2
        + (FIT_STEPS * chip_smoke.HEADLINE_SEQS * chip_smoke.HEADLINE_SEQ, "tokens", bf16),
        "vgg16_int8_forward": (lambda: qnet.output(images), lambda: served(qforward, qnet, images),
                               chip_smoke.VGG_BATCH, "images", serving),
        "resnet50_two_slice_step": (lambda: dcn.fit_batch(dcn_data),) * 2
        + (chip_smoke.DCN_SLICES * chip_smoke.DCN_BATCH, "images", f32)}
    for name, (small_trainer, small_batch, size, unit) in small.items():
        workloads[name] = ((lambda t=small_trainer, b=small_batch: t.fit_batch(b),) * 2
                           + (size, unit, f32))
    modes = {"eager": capture.eager, "captured": contextlib.nullcontext}

    def measure(name, mode, what):
        eager_fn, captured_fn, items, unit, policy = workloads[name]
        fn = eager_fn if mode == "eager" else captured_fn

        def go():
            with modes[mode]():
                return what(fn, items, unit)
        return in_policy(policy, go)

    # every timing and host reading before the first trace: a profiler
    # session leaves the launch path slower for the rest of the process
    chosen = sys.argv[1:] or list(workloads)
    unknown = sorted(set(chosen) - set(workloads))
    if unknown:
        print(f"chip_profile: unknown workloads {unknown}; known: {list(workloads)}",
              file=sys.stderr)
        return 2
    keys = [(name, mode) for name in chosen for mode in modes]
    run_ms = {k: measure(*k, lambda fn, *_: chip_smoke.cuda_ms(fn, reps=ITERS, warmup=3))
              for k in keys}
    host = {k: measure(*k, lambda fn, *_, k=k: host_time(
        fn, max(ITERS, math.ceil(HOST_WINDOW_MS / run_ms[k])))) for k in keys}
    for k in keys:
        host[k].update(measure(*k, lambda fn, *_: launch_api(fn)))
    results = {}
    for name, mode in keys:
        print(f"[{mode}]", flush=True)
        results.setdefault(name, {})[mode] = measure(
            name, mode, lambda fn, items, unit: profile(card, name, fn, run_ms[name, mode],
                                                        items, unit, host[name, mode]))
    out = chip_smoke.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_profile.json").write_text(json.dumps(results, indent=1))
    dcn.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
