#!/usr/bin/env python3
"""Where the time of the port's ResNet-50 forward and training step, of
its BERT fine-tune step and of its int8 VGG-16 serving forward goes on
one CUDA card.

    python3 chip_profile.py

Builds the same seeded models as ``chip_smoke.py`` (TF32 off) and, for
each workload, warms it up, times it with CUDA events (every workload
before any tracing) and traces ``ITERS`` runs with ``torch.profiler``:

- ``forward``: ResNet-50 ``net.output`` on ``chip_smoke.BATCH`` images
  (the serving forward), f32;
- ``train_step``: ResNet-50 ``Trainer.fit_batch`` (forward, backward,
  update) at ``chip_smoke.TRAIN_LR``, f32;
- ``bert_finetune_step``: one ``BertForMaskedLM.fit`` step of bench.py's
  long-sequence configuration (4 layers of BERT-base, batch 2 x 4096,
  bf16 policy, flash attention, ``Adam(2e-5)``);
- ``vgg16_int8_forward``: ``qnet.output`` of VGG-16 quantized by
  ``quantize_net``, on ``chip_smoke.VGG_BATCH`` images under the bf16
  serving policy (bf16 params, compute and outputs), its three dense
  layers through the int8 kernel and its convolutions' weights widened
  on read.

Prints the card's name and power limit and, per workload, its wall time
from CUDA events, the device time per category of kernel (this repo's
``matmul_bn_act``, flash attention and int8 kernels, convolutions,
matmuls, softmax, elementwise, copies and casts, pooling and reductions,
other) per run,
the busy share of the device over the traced window, and the 15 kernels
with the most device time.  Writes the same to
``chiprun_out/chip_profile.json``.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke

ITERS = 5

CATEGORIES = (
    ("int8_matmul", ("int8_mm_f32_kernel", "int8_mm_bf16_kernel", "int8_mm_reduce_kernel")),
    ("matmul_bn_act", ("mba_f32_kernel", "mba_bf16_kernel", "stats_reduce_kernel")),
    ("matmul_bn_act_bwd", ("bwd_dx_f32_kernel", "bwd_dw_f32_kernel", "bwd_dx_bf16_kernel",
                           "bwd_dw_bf16_kernel", "colsum_kernel")),
    ("flash_attention", ("fa_fwd_f32_kernel", "fa_fwd_bf16_kernel")),
    ("flash_attention_bwd", ("fa_bwd_f32_kernel", "fa_bwd_bf16_kernel", "dq_reduce_kernel")),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft")),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90")),
    ("softmax", ("softmax",)),
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


def profile(card: str, name: str, fn, run_ms: float, items: int, unit: str) -> dict:
    """Trace ITERS runs of ``fn`` (warm already, timed at ``run_ms``), each
    of ``items`` images or tokens (``unit``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us and getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + dev_us / 1e3 / ITERS
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    by_cat: dict[str, float] = {}
    for kname, ms in kernels.items():
        by_cat[category(kname)] = by_cat.get(category(kname), 0.0) + ms
    device_ms = sum(kernels.values())
    result = {"workload": name, "card": card, "items": items, "unit": unit, "iters": ITERS,
              "ms": run_ms, f"{unit}_per_s": items / run_ms * 1e3,
              "device_ms": device_ms, "busy_share": device_ms * ITERS / window_ms,
              "categories_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
              "top_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15])}
    print(f"{name}, {items} {unit} on {card}: {run_ms:.3f} ms "
          f"({result[f'{unit}_per_s']:.1f} {unit}/s); device time {device_ms:.3f} ms "
          f"per run, busy {result['busy_share']:.1%} of the traced window")
    for cat, ms in result["categories_ms"].items():
        print(f"  {cat:18s} {ms:8.3f} ms  {ms / device_ms:6.1%}")
    for kname, ms in result["top_kernels_ms"].items():
        print(f"  {ms:8.3f} ms  {kname[:110]}")
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import BertForMaskedLM, vgg16
    from deeplearning4j_tpu_torch.nn.quantize import quantize_net
    from deeplearning4j_tpu_torch.train import Adam, Nesterovs, Trainer
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
    bert = BertForMaskedLM(chip_smoke.bert_config(chip_smoke.BERT_TRAIN_LAYERS, use_flash=True),
                           seed=0, device="cuda")
    bert_batch = chip_smoke.bert_batch(bert.config.vocab_size)
    adam = Adam(chip_smoke.BERT_TRAIN_LR)
    tokens = chip_smoke.BERT_BATCH * chip_smoke.BERT_SEQ
    serving = config.DTypePolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                                 output_dtype=torch.bfloat16)

    def in_policy(policy, fn):
        config.set_dtype_policy(policy)
        try:
            return fn()
        finally:
            config.set_dtype_policy(config.DTypePolicy.f32())

    qnet = in_policy(serving,
                     lambda: quantize_net(vgg16(device="cuda").init(seed=chip_smoke.SEED)))
    images = torch.randn(chip_smoke.VGG_BATCH, 224, 224, 3, device="cuda", generator=gen)
    f32, bf16 = config.DTypePolicy.f32(), config.DTypePolicy.bf16()
    # name: (run, items per run, unit, dtype policy)
    workloads = {"forward": (lambda: net.output(x), chip_smoke.BATCH, "images", f32),
                 "train_step": (lambda: trainer.fit_batch(batch), chip_smoke.BATCH, "images",
                                f32),
                 "bert_finetune_step": (lambda: bert.fit([bert_batch], updater=adam), tokens,
                                        "tokens", bf16),
                 "vgg16_int8_forward": (lambda: qnet.output(images), chip_smoke.VGG_BATCH,
                                        "images", serving)}

    # every timing before the first trace: a profiler session leaves the
    # launch path slower for the rest of the process
    run_ms = {name: in_policy(policy, lambda: chip_smoke.cuda_ms(fn, reps=ITERS, warmup=3))
              for name, (fn, _, _, policy) in workloads.items()}
    results = [in_policy(policy, lambda: profile(card, name, fn, run_ms[name], items, unit))
               for name, (fn, items, unit, policy) in workloads.items()]
    out = chip_smoke.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_profile.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
