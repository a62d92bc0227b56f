#!/usr/bin/env python3
"""Where the time of the port's ResNet-50 forward goes, on one CUDA card.

    python3 chip_profile.py

Builds the same seeded full-width ResNet-50 as ``chip_smoke.py`` (f32,
TF32 off), warms it up, then traces ``ITERS`` forwards of one batch of
``chip_smoke.BATCH`` images already on the card with ``torch.profiler``.
Prints the card's name and power limit, the forward's wall time from
CUDA events, the device time
per category of kernel (this repo's ``matmul_bn_act``, convolutions,
elementwise, copies, pooling and reductions, other) per forward, the
busy share of the device over the traced window, and the 15 kernels
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
    ("matmul_bn_act", ("mba_f32_kernel", "mba_bf16_kernel", "stats_reduce_kernel")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "winograd", "fft", "sm90")),
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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)

    net = chip_smoke.build_net()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    x = torch.randn(chip_smoke.BATCH, 224, 224, 3, device="cuda", generator=gen)
    fwd_ms = chip_smoke.cuda_ms(lambda: net.output(x), reps=ITERS, warmup=3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            net.output(x)
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
    for name, ms in kernels.items():
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
    device_ms = sum(kernels.values())
    result = {"card": card, "batch": chip_smoke.BATCH, "iters": ITERS,
              "forward_ms": fwd_ms, "images_per_s": chip_smoke.BATCH / fwd_ms * 1e3,
              "device_ms_per_forward": device_ms,
              "busy_share": device_ms * ITERS / window_ms,
              "categories_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
              "top_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15])}
    print(f"forward at batch {chip_smoke.BATCH} on {card}: {fwd_ms:.3f} ms "
          f"({result['images_per_s']:.1f} images/s); device time {device_ms:.3f} ms "
          f"per forward, busy {result['busy_share']:.1%} of the traced window")
    for cat, ms in result["categories_ms"].items():
        print(f"  {cat:14s} {ms:8.3f} ms  {ms / device_ms:6.1%}")
    for name, ms in result["top_kernels_ms"].items():
        print(f"  {ms:8.3f} ms  {name[:110]}")
    out = chip_smoke.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_profile.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
