"""Statistics pipeline: per-layer param, gradient and update statistics,
their storage and an HTML report (port of
``deeplearning4j_tpu/obs/stats.py``).

The statistics are computed on the device inside the training step
(``train.trainer.make_train_step(with_stats=True)``, the step the
trainer runs on the iterations a sampling listener asks for), so a sample
costs one copy of a few kB to the host, never the tensors themselves:
:func:`device_layer_stats` gives each layer's statistics as tensors,
:func:`pack_stats` packs every group's into one tensor (the step's
output), and :func:`unpack_stats` turns that tensor, read once, back into
the nested dict the listeners get.  The histogram is ``jnp.histogram``'s
(20 bins over ``[min, min + span]``, the last bin closed) computed with
tensor bounds: ``torch.histc`` takes its range as host numbers and
``torch.bincount`` reads its maximum, either of which waits for the
device and cannot be captured into a CUDA graph.

Records (``InMemoryStatsStorage``, ``FileStatsStorage``) and the report
(:func:`render_html`) are the JAX package's: either package reads the
other's jsonl.
"""

from __future__ import annotations

import html as _html
import json
import math
import os
from typing import Optional

import torch

from deeplearning4j_tpu_torch.obs.listeners import TrainingListener

NUM_BINS = 20
# a sample's groups, and each layer's scalars in their packed order
GROUPS = ("params", "gradients", "updates")
SCALARS = ("norm", "mean", "stdev", "mean_magnitude", "min", "max", "zero_fraction", "hist_max")


# ============================================================ device side
def _float_leaves(tree) -> list:
    """The floating tensors of ``tree`` in ``jax.tree_util``'s flatten order
    (dict keys sorted at every level, lists in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _float_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in _float_leaves(node)]
    return [tree] if torch.is_tensor(tree) and tree.is_floating_point() else []


def _leaf_concat(tree) -> Optional[torch.Tensor]:
    """The floating leaves of ``tree`` flattened into one f32 vector, in
    ``jax.tree_util``'s leaf order (dict keys sorted), as the JAX package
    concatenates them; None without such leaves."""
    leaves = _float_leaves(tree)
    if not leaves:
        return None
    return torch.cat([leaf.detach().reshape(-1).float() for leaf in leaves])


def _histogram(vec: torch.Tensor, lo: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """``jnp.histogram(vec, NUM_BINS, range=(lo, top))[0]`` as int64 counts,
    with ``lo`` and ``top`` 0-dim tensors on ``vec``'s device: the edges
    are ``jnp.linspace``'s (``start * (1 - i / n) + stop * i / n`` in f32,
    the last edge ``stop``; an empty range widened by 0.5 each way), a
    value counts in the bin whose left edge it reaches (``searchsorted``,
    side right), a value on the last edge in the last bin and one past it
    in none.  Counted by comparing every value with every edge and summing
    in int32, which reads nothing on the host and adds no atomics, so it is
    the same in a CUDA graph and under deterministic algorithms (where a
    scatter-add of bin indices would sort them)."""
    flat = top == lo
    start = torch.where(flat, lo - 0.5, lo)
    stop = torch.where(flat, top + 0.5, top)
    frac = torch.arange(NUM_BINS, dtype=torch.float32, device=vec.device) / NUM_BINS
    left = start * (1 - frac) + stop * frac
    reached = (vec.unsqueeze(0) >= left.unsqueeze(1)).sum(1, dtype=torch.int32)   # per left edge
    past = (vec > stop).sum(dtype=torch.int32).reshape(1)                         # past the last
    return (reached - torch.cat([reached[1:], past])).long()


def _stats_of(vec: torch.Tensor) -> dict:
    lo, hi = torch.aminmax(vec)
    span = torch.where(hi - lo < 1e-12, torch.ones_like(lo), hi - lo)
    top = lo + span
    mean = vec.mean()
    return {
        # sums of squares through torch.sum, which adds in a cascade on the
        # CPU: its vector_norm reads ~1e-4 off over millions of f32 entries
        "norm": vec.square().sum().sqrt(),
        "mean": mean,
        "stdev": (vec - mean).square().mean().sqrt(),      # jnp.std's two passes
        "mean_magnitude": vec.abs().mean(),
        "min": lo,
        "max": hi,
        # dead-unit signal for obs.health: the fraction of ~zero entries
        "zero_fraction": (vec.abs() < 1e-8).float().mean(),
        "hist_counts": _histogram(vec, lo, top),
        "hist_min": lo,
        "hist_max": top,
    }


def _layer_items(tree) -> list:
    """``(key, layer tree)`` of a list (``MultiLayerNetwork``) or dict
    (``ComputationGraph``) of per-layer param trees."""
    return [(str(k), sub) for k, sub in (enumerate(tree) if isinstance(tree, list) else tree.items())]


def stats_keys(tree) -> list:
    """The layers :func:`device_layer_stats` reports for ``tree``: those
    with at least one floating entry, in the tree's order.  A gradient or
    update tree has its params' keys."""
    return [k for k, sub in _layer_items(tree) if sum(leaf.numel() for leaf in _float_leaves(sub))]


def device_layer_stats(tree) -> dict:
    """Per-layer statistics of ``tree`` (a list or dict of per-layer param
    trees) as tensors on its device: norm, mean, stdev, mean magnitude,
    min, max, the fraction of entries below 1e-8 in magnitude, and the
    histogram (``hist_counts``, int64, over ``[hist_min, hist_max]``)."""
    out = {}
    for key, sub in _layer_items(tree):
        vec = _leaf_concat(sub)
        if vec is not None and vec.numel():
            out[key] = _stats_of(vec)
    return out


def pack_stats(stats: dict) -> torch.Tensor:
    """``{group: device_layer_stats(...)}`` (groups in :data:`GROUPS` order,
    layers in each group's order) as one f64 tensor: every layer's
    :data:`SCALARS`, then every layer's ``NUM_BINS`` counts.  f64 holds
    each f32 statistic and each count exactly."""
    layers = [st for group in GROUPS for st in stats[group].values()]
    scalars = torch.cat([torch.stack([st[name] for name in SCALARS]) for st in layers])
    counts = torch.cat([st["hist_counts"] for st in layers])
    return torch.cat([scalars.double(), counts.double()])


def unpack_stats(packed, keys: list) -> dict:
    """:func:`pack_stats`'s tensor (read to the host once; a list of its
    values is taken as is) back into ``{group: {layer: {stat: value}}}``
    of host numbers, ``keys`` the layers of each group (:func:`stats_keys`
    of the params).  Values are Python floats, ``hist_counts`` a list of
    them, as the JAX package's ``_host`` gives them."""
    values = packed.tolist() if torch.is_tensor(packed) else list(packed)
    n_scalars = len(SCALARS)
    n_layers = len(GROUPS) * len(keys)
    if len(values) != n_layers * (n_scalars + NUM_BINS):
        raise ValueError(f"packed statistics hold {len(values)} values, not the "
                         f"{n_layers * (n_scalars + NUM_BINS)} of {len(keys)} layers")
    out: dict = {group: {} for group in GROUPS}
    for i in range(n_layers):
        group, key = GROUPS[i // len(keys)], keys[i % len(keys)]
        st = dict(zip(SCALARS, values[i * n_scalars:(i + 1) * n_scalars]))
        base = n_layers * n_scalars + i * NUM_BINS
        st["hist_counts"] = values[base:base + NUM_BINS]
        st["hist_min"] = st["min"]
        out[group][key] = st
    return out

# ============================================================== storage
class InMemoryStatsStorage:
    """(``InMemoryStatsStorage`` parity) record dicts in a list."""

    def __init__(self):
        self.records: list[dict] = []

    def put(self, record: dict) -> None:
        self.records.append(record)

    def all(self) -> list[dict]:
        return list(self.records)


class FileStatsStorage(InMemoryStatsStorage):
    """(``FileStatsStorage`` parity) jsonl file, replayable."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                self.records = [json.loads(line) for line in f if line.strip()]
        self._f = open(path, "a")

    def put(self, record: dict) -> None:
        super().put(record)
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# ============================================================== listener
def _host(stats_tree) -> dict:
    """A stats tree with host values: its tensors come to the host in one
    packed copy, not a read per scalar; a 0-dim value becomes a float
    (None where it is not finite: JSON has no NaN), an array a list."""
    tensors: list = []

    def collect(v):
        if isinstance(v, dict):
            for x in v.values():
                collect(x)
        elif torch.is_tensor(v):
            tensors.append(v)
    collect(stats_tree)
    flat = iter(torch.cat([t.detach().reshape(-1).double() for t in tensors]).tolist()
                if tensors else [])

    def scalar(f):
        f = float(f)
        return f if math.isfinite(f) else None

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if torch.is_tensor(v):
            values = [next(flat) for _ in range(v.numel())]
            return scalar(values[0]) if v.ndim == 0 else values
        if isinstance(v, (list, tuple)):
            return [float(x) for x in v]
        return scalar(v)
    return conv(stats_tree)


def model_topology(model) -> Optional[dict]:
    """Static model description for the UI's Model tab
    (``StatsInitializationReport`` parity): node list + edges."""
    conf = getattr(model, "conf", None)
    if conf is None:
        return None
    if hasattr(conf, "vertices"):          # ComputationGraph
        nodes, edges = [], []
        for n in conf.inputs:
            nodes.append({"name": n, "kind": "input"})
        # topo order, not insertion order — the SVG layout computes node
        # depth in one pass over the node list
        for spec in conf.topo_order():
            label = type(spec.obj).__name__
            n_out = getattr(spec.obj, "n_out", None)
            nodes.append({"name": spec.name, "kind": label,
                          **({"n_out": n_out} if n_out else {})})
            edges += [[src, spec.name] for src in spec.inputs]
        return {"nodes": nodes, "edges": edges, "outputs": list(conf.outputs)}
    if hasattr(conf, "layers"):            # MultiLayerNetwork
        nodes = [{"name": "input", "kind": "input"}]
        edges = []
        prev = "input"
        for i, layer in enumerate(conf.layers):
            name = layer.name or f"layer_{i}"
            n_out = getattr(layer, "n_out", None)
            nodes.append({"name": name, "kind": type(layer).__name__,
                          **({"n_out": n_out} if n_out else {})})
            edges.append([prev, name])
            prev = name
        return {"nodes": nodes, "edges": edges, "outputs": [prev]}
    return None


class StatsListener(TrainingListener):
    """Samples model stats every N iterations into a StatsStorage
    (``StatsListener.java`` parity).  The Trainer detects this listener
    (``wants_model_stats``) and runs its stats-collecting train step on
    sampling iterations, then dispatches ``stats_ready``.  The first
    record is a one-time static ``init`` record carrying the model
    topology (``StatsInitializationReport`` parity) for the Model tab."""

    wants_model_stats = True

    def __init__(self, storage, frequency: int = 10):
        self.storage = storage
        self.frequency = max(frequency, 1)
        self._last_stats_iteration = -1
        self._init_sent = False

    def _maybe_send_init(self, model):
        if self._init_sent:
            return
        self._init_sent = True
        topo = model_topology(model)
        if topo is None:
            return
        # a replayed FileStatsStorage may already carry this topology from
        # a prior run — don't append a duplicate
        for r in reversed(self.storage.all()):
            if r.get("type") == "init":
                if r.get("model") == topo:
                    return
                break
        self.storage.put({"type": "init", "model": topo})

    def wants_stats_now(self, iteration: int) -> bool:
        return iteration % self.frequency == 0

    def stats_ready(self, model, iteration: int, epoch: int, score: float,
                    stats: dict) -> None:
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        self._maybe_send_init(model)
        self._last_stats_iteration = iteration
        record = {"type": "stats", "iteration": iteration, "epoch": epoch,
                  "score": float(score)}
        record.update(_host(stats))
        self.storage.put(record)
        get_registry().counter("tpudl_obs_stats_samples_total").inc()

    def iteration_done(self, model, iteration, epoch, score):
        self._maybe_send_init(model)
        # score-only record whenever stats_ready did NOT fire this
        # iteration (non-sampled iterations, and paths without a stats
        # step like tBPTT) — keeps the score chart dense
        if iteration != self._last_stats_iteration:
            self.storage.put({"type": "score", "iteration": iteration,
                              "epoch": epoch, "score": float(score)})


# ================================================================ report
_SVG_W, _SVG_H, _PAD = 640, 180, 30


def _polyline(xs, ys, w=_SVG_W, h=_SVG_H, color="#1f77b4"):
    if not xs:
        return ""
    x0, x1 = min(xs), max(xs) or 1
    finite = [y for y in ys if y is not None and math.isfinite(y)]
    if not finite:
        return ""
    y0, y1 = min(finite), max(finite)
    span_x = (x1 - x0) or 1
    span_y = (y1 - y0) or 1
    pts = " ".join(
        f"{_PAD + (x - x0) / span_x * (w - 2 * _PAD):.1f},"
        f"{h - _PAD - (y - y0) / span_y * (h - 2 * _PAD):.1f}"
        for x, y in zip(xs, ys) if y is not None and math.isfinite(y))
    return (f'<svg width="{w}" height="{h}">'
            f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{pts}"/>'
            f'<text x="{_PAD}" y="12" font-size="10">max {y1:.4g}</text>'
            f'<text x="{_PAD}" y="{h - 8}" font-size="10">min {y0:.4g}</text>'
            f'</svg>')


def _histogram_svg(counts, lo, hi, w=320, h=120, color="#ff7f0e"):
    if not counts:
        return ""
    peak = max(counts) or 1
    n = len(counts)
    bw = (w - 2 * _PAD) / n
    bars = "".join(
        f'<rect x="{_PAD + i * bw:.1f}" '
        f'y="{h - _PAD - c / peak * (h - 2 * _PAD):.1f}" '
        f'width="{max(bw - 1, 1):.1f}" '
        f'height="{c / peak * (h - 2 * _PAD):.1f}" fill="{color}"/>'
        for i, c in enumerate(counts))
    return (f'<svg width="{w}" height="{h}">{bars}'
            f'<text x="{_PAD}" y="{h - 8}" font-size="10">{lo:.3g}</text>'
            f'<text x="{w - _PAD - 40}" y="{h - 8}" font-size="10">{hi:.3g}</text>'
            f'</svg>')


def _topology_svg(topo: dict) -> str:
    """Model-tab rendering: topo-layered boxes with edges (the reference
    web UI's graph view, server-side SVG here).  Node depth = longest
    path from an input, nodes at equal depth spread horizontally."""
    nodes = topo.get("nodes", [])
    edges = topo.get("edges", [])
    depth: dict[str, int] = {}
    preds: dict[str, list] = {}
    for src, dst in edges:
        preds.setdefault(dst, []).append(src)
    for n in nodes:                       # nodes arrive topo-sorted
        name = n["name"]
        depth[name] = 1 + max((depth.get(p, 0) for p in preds.get(name, [])),
                              default=0) if preds.get(name) else 0
    rows: dict[int, list] = {}
    for n in nodes:
        rows.setdefault(depth[n["name"]], []).append(n)
    bw, bh, vgap, hgap = 150, 34, 26, 16
    width = max((len(r) for r in rows.values()), default=1) * (bw + hgap) + hgap
    height = (max(rows, default=0) + 1) * (bh + vgap) + vgap
    pos: dict[str, tuple] = {}
    boxes = []
    for d, row in sorted(rows.items()):
        total = len(row) * (bw + hgap) - hgap
        x0 = (width - total) / 2
        for j, n in enumerate(row):
            x, y = x0 + j * (bw + hgap), vgap + d * (bh + vgap)
            pos[n["name"]] = (x + bw / 2, y)
            raw = (n["name"] if n["kind"] == "input" else
                   f"{n['name']}: {n['kind']}"
                   + (f" ({n['n_out']})" if n.get("n_out") else ""))
            # truncate BEFORE escaping — slicing an escaped string can
            # split an entity like &amp; mid-sequence
            label = _html.escape(raw[:26])
            fill = "#e8f0fe" if n["kind"] != "input" else "#e6f4ea"
            boxes.append(
                f'<rect x="{x:.0f}" y="{y:.0f}" width="{bw}" height="{bh}" '
                f'rx="6" fill="{fill}" stroke="#888"/>'
                f'<text x="{x + bw / 2:.0f}" y="{y + bh / 2 + 4:.0f}" '
                f'font-size="10" text-anchor="middle">{label}</text>')
    lines = []
    for src, dst in edges:
        if src in pos and dst in pos:
            (x1, y1), (x2, y2) = pos[src], pos[dst]
            lines.append(f'<line x1="{x1:.0f}" y1="{y1 + bh:.0f}" '
                         f'x2="{x2:.0f}" y2="{y2:.0f}" stroke="#aaa"/>')
    return (f'<svg width="{width:.0f}" height="{height:.0f}">'
            + "".join(lines) + "".join(boxes) + "</svg>")


def render_html_report(storage, out_path: str, title: str = "Training report") -> str:
    """StatsStorage → static self-contained HTML (UI-lite per SURVEY §2.8):
    score chart, per-layer param/grad/update norms and update:param
    mean-magnitude ratio over time, latest histograms."""
    html = render_html(storage, title)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def render_html(storage, title: str = "Training report",
                refresh_seconds: int = 0) -> str:
    """Render the report to a string (the static report's body; the JAX
    package's live UI server renders the same string)."""
    records = storage.all() if hasattr(storage, "all") else list(storage)
    scores = [(r["iteration"], r.get("score")) for r in records
              if r.get("score") is not None]
    stats = [r for r in records if r.get("type") == "stats"]

    refresh = (f"<meta http-equiv='refresh' content='{refresh_seconds}'>"
               if refresh_seconds else "")
    parts = [f"<html><head><meta charset='utf-8'>{refresh}"
             f"<title>{title}</title>",
             "<style>body{font-family:sans-serif;margin:24px} "
             "h2{border-bottom:1px solid #ccc} .row{display:flex;gap:24px;"
             "flex-wrap:wrap} .card{margin:8px}</style></head><body>",
             f"<h1>{title}</h1>"]

    inits = [r for r in records if r.get("type") == "init"]
    if inits:
        parts.append("<h2>Model</h2>")
        # latest topology: a replayed storage may carry older runs' models
        parts.append(_topology_svg(inits[-1]["model"]))

    parts.append("<h2>Score (loss)</h2>")
    parts.append(_polyline([i for i, _ in scores], [s for _, s in scores]))

    layer_names: list[str] = []
    if stats:
        layer_names = sorted(stats[-1].get("params", {}),
                             key=lambda k: (len(k), k))
    for group, color in (("params", "#1f77b4"), ("gradients", "#2ca02c"),
                         ("updates", "#d62728")):
        if not stats:
            break
        parts.append(f"<h2>{group}: L2 norm per layer</h2><div class='row'>")
        for name in layer_names:
            xs = [r["iteration"] for r in stats if name in r.get(group, {})]
            ys = [r[group][name]["norm"] for r in stats
                  if name in r.get(group, {})]
            parts.append(f"<div class='card'><h4>layer {name}</h4>"
                         f"{_polyline(xs, ys, w=320, h=140, color=color)}</div>")
        parts.append("</div>")

    if stats:
        parts.append("<h2>update : param mean-magnitude ratio (log10)</h2>"
                     "<div class='row'>")
        for name in layer_names:
            xs, ys = [], []
            for r in stats:
                p = r.get("params", {}).get(name)
                u = r.get("updates", {}).get(name)
                if p and u and p["mean_magnitude"] and u["mean_magnitude"]:
                    xs.append(r["iteration"])
                    ys.append(math.log10(u["mean_magnitude"] /
                                         max(p["mean_magnitude"], 1e-30)))
            parts.append(f"<div class='card'><h4>layer {name}</h4>"
                         f"{_polyline(xs, ys, w=320, h=140, color='#9467bd')}</div>")
        parts.append("</div>")

        last = stats[-1]
        parts.append("<h2>Latest parameter histograms</h2><div class='row'>")
        for name in layer_names:
            st = last.get("params", {}).get(name)
            if st:
                parts.append(
                    f"<div class='card'><h4>layer {name}</h4>"
                    f"{_histogram_svg(st['hist_counts'], st['hist_min'], st['hist_max'])}"
                    f"</div>")
        parts.append("</div>")

    parts.append("</body></html>")
    return "\n".join(parts)
