"""Process-level step cache (port of ``deeplearning4j_tpu/train/step_cache.py``).

``MultiLayerNetwork.fit`` and ``ComputationGraph.fit`` build a fresh
:class:`~deeplearning4j_tpu_torch.train.trainer.Trainer` per call, and the
serving engine is made per model.  Each of those would otherwise build
and capture its own step (``train/capture.py``: a CUDA graph per batch
signature, the port's counterpart of the JAX package's ``jax.jit``)
even when the network config and updater are identical.  This module
keys the steps by

    (net class, sha1(conf.to_json()), dtype policy,
     updater signature, sharding signature, step kind)

so that every trainer, ``eval_loss`` and engine of one configuration
reuses ONE step object and the graphs it has captured.  The cached step
closes over the *first* net of its key; reuse is sound because the
forward and loss are functions of ``(params, state, batch)`` alone and
the key pins every config fact they read.  A ``None`` key (a conf that
cannot be serialized) builds per caller, uncached.

Hits and misses are counted under the JAX package's metric names
(:data:`HITS`, :data:`MISSES`) in the metrics registry, and since the
process started in :func:`counters` (which a swapped registry does not
reset).  Not ported yet: the cost-model tag of every cached step
(``obs/costmodel.py``) and the artifact store's wrap
(``train/artifact_store.py``).
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

from deeplearning4j_tpu_torch.config import dtype_policy
from deeplearning4j_tpu_torch.obs.registry import get_registry
from deeplearning4j_tpu_torch.train import updaters as updater_mod

# Bounded so that a process that churns through many configs (a sweep)
# does not pin every net it ever trained: past this many (config, kind)
# pairs the least recently used step (its net and its graphs) falls out.
MAX_ENTRIES = 128

HITS = "tpudl_train_step_cache_hits_total"
MISSES = "tpudl_train_step_cache_misses_total"

_CACHE: "OrderedDict[tuple, Any]" = OrderedDict()
_LOCK = threading.Lock()
_COUNTS = {HITS: 0, MISSES: 0}


def net_signature(net) -> Optional[tuple]:
    """Everything the step reads on the model side: the net's class, the
    sha1 of its configuration's JSON and the dtype policy.  ``None`` when
    the configuration cannot be serialized (the caller then skips the
    cache)."""
    to_json = getattr(getattr(net, "conf", None), "to_json", None)
    if to_json is None:
        return None
    try:
        conf_sha = hashlib.sha1(to_json().encode()).hexdigest()
    except (TypeError, ValueError):
        return None
    pol = dtype_policy()
    return (type(net).__name__, conf_sha, str(pol.param_dtype), str(pol.compute_dtype),
            str(pol.output_dtype))


def updater_signature(conf) -> Optional[str]:
    """Identity of the optimizer the step closes over: the updater (its
    JSON dict with every field filled in) and the gradient normalization
    with its threshold; ``None`` when the updater cannot be read."""
    updater = getattr(conf, "updater", None)
    try:
        d = updater_mod.to_dict(updater_mod.from_dict(updater)) if updater is not None else None
    except (KeyError, TypeError, ValueError, NotImplementedError):
        return None
    return json.dumps([d, getattr(conf, "gradient_normalization", None),
                       getattr(conf, "gradient_normalization_threshold", None)],
                      sort_keys=True, default=repr)


def sharding_signature(layout) -> str:
    """The placement a step runs under: ``""`` for a single device, a
    data-parallel layout's ``step_signature()`` (``parallel.mesh.
    MeshLayout``: its axes and device kind, and ``|eager:gloo`` where its
    steps cannot be captured).  Per-leaf shardings (the JAX package's
    NamedSharding trees) belong to the model-axis layouts of
    ``parallel/``, not ported yet."""
    if layout is None:
        return ""
    if hasattr(layout, "step_signature"):
        return layout.step_signature()
    raise NotImplementedError("per-leaf shardings wait for the model-axis layouts of "
                              "parallel/, which are not ported yet")


def get_or_build(key: Optional[tuple], builder: Callable[[], Any]) -> Any:
    """The cached step of ``key``, built (and cached) on first sight;
    ``key=None`` bypasses the cache.  The builder runs outside the lock,
    so a slow build does not hold up other keys; of two racing builds of
    one key the first to finish is kept."""
    if key is None:
        return builder()
    with _LOCK:
        step = _CACHE.get(key)
        if step is not None:
            _CACHE.move_to_end(key)
            _count(HITS)
            return step
    step = builder()
    with _LOCK:
        existing = _CACHE.get(key)
        if existing is not None:
            _count(HITS)
            return existing
        _CACHE[key] = step
        _count(MISSES)
        while len(_CACHE) > MAX_ENTRIES:
            _CACHE.popitem(last=False)
    return step


def _count(name: str) -> None:
    _COUNTS[name] += 1
    get_registry().counter(name).inc()


def counters() -> dict:
    """The hit and miss counts since the process started (``clear_step_cache``
    leaves them)."""
    with _LOCK:
        return dict(_COUNTS)


def cached_steps() -> list:
    """The steps the cache holds, least recently used first."""
    with _LOCK:
        return list(_CACHE.values())


def cache_size() -> int:
    with _LOCK:
        return len(_CACHE)


def drop_sharding(signature: str) -> int:
    """Drop every step built under the placement ``signature``
    (:func:`sharding_signature`; a resize's old width); returns how many."""
    with _LOCK:
        keys = [k for k in _CACHE if len(k) >= 2 and k[-2] == signature]
        for k in keys:
            del _CACHE[k]
    return len(keys)


def clear_step_cache() -> None:
    """Drop every cached step, and with them the nets they close over and
    the graphs (and memory pools) they captured."""
    with _LOCK:
        _CACHE.clear()


def captured_graphs(*steps) -> int:
    """How many CUDA graphs the given steps hold in all (``None`` and
    steps that capture nothing count zero)."""
    return sum(getattr(step, "graph_count", 0) for step in steps if step is not None)


def seen_signatures(*steps) -> int:
    """How many distinct call signatures the given steps have seen in all
    (``None`` counts zero): the counterpart of the JAX package's
    ``jit_cache_entries``, whose delta across a call says that a new
    program was traced.  A step of the port compiles nothing; its first
    call of a signature runs eagerly where JAX traces and compiles, and on
    the card a later call of it captures the graph."""
    return sum(getattr(step, "signature_count", 0) for step in steps if step is not None)
