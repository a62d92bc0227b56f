"""TF BERT checkpoint names <-> the port's BERT parameter tree (port of
``deeplearning4j_tpu/importers/tf_bert.py``).

Input: ``{tf_variable_name: np.ndarray}`` (an npz conversion of a
google-research BERT checkpoint, ``bert/encoder/layer_N/...`` naming).
Output: the parameter tree of ``deeplearning4j_tpu_torch.models.bert`` as
numpy arrays, ready for ``interop.load_jax_bert_params``.  TF kernels are
[in, out], as the port's are: the work is name mapping and config
inference, over numpy.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

import torch

from deeplearning4j_tpu_torch.models.bert import BertConfig, init_params


def infer_config(variables: dict[str, np.ndarray]) -> BertConfig:
    """Derive BertConfig from checkpoint tensor shapes."""
    word = variables["bert/embeddings/word_embeddings"]
    pos = variables["bert/embeddings/position_embeddings"]
    tok = variables["bert/embeddings/token_type_embeddings"]
    n_layers = 0
    while f"bert/encoder/layer_{n_layers}/attention/self/query/kernel" in variables:
        n_layers += 1
    inter = variables["bert/encoder/layer_0/intermediate/dense/kernel"]
    hidden = word.shape[1]
    # heads: BERT convention head_size 64
    num_heads = max(hidden // 64, 1)
    return BertConfig(vocab_size=word.shape[0], hidden_size=hidden,
                      num_layers=n_layers, num_heads=num_heads,
                      intermediate_size=inter.shape[1],
                      max_position=pos.shape[0], type_vocab_size=tok.shape[0])


def _dense(variables, prefix):
    return {"kernel": np.asarray(variables[f"{prefix}/kernel"]),
            "bias": np.asarray(variables[f"{prefix}/bias"])}


def _ln(variables, prefix):
    return {"gamma": np.asarray(variables[f"{prefix}/gamma"]),
            "beta": np.asarray(variables[f"{prefix}/beta"])}


def map_variables(variables: dict[str, np.ndarray],
                  config: BertConfig | None = None) -> tuple[BertConfig, dict]:
    """TF name space → the port's param tree.  Raises KeyError naming the first
    missing variable (as ImportGraph's unmapped-op error does)."""
    config = config or infer_config(variables)
    params: dict[str, Any] = {
        "embeddings": {
            "word_embeddings": np.asarray(variables["bert/embeddings/word_embeddings"]),
            "position_embeddings": np.asarray(variables["bert/embeddings/position_embeddings"]),
            "token_type_embeddings": np.asarray(variables["bert/embeddings/token_type_embeddings"]),
            "layer_norm": _ln(variables, "bert/embeddings/LayerNorm"),
        },
        "encoder": {},
        "pooler": _dense(variables, "bert/pooler/dense"),
        "mlm": {},
    }
    for i in range(config.num_layers):
        base = f"bert/encoder/layer_{i}"
        params["encoder"][f"layer_{i}"] = {
            "attention": {
                "query": _dense(variables, f"{base}/attention/self/query"),
                "key": _dense(variables, f"{base}/attention/self/key"),
                "value": _dense(variables, f"{base}/attention/self/value"),
                "output": _dense(variables, f"{base}/attention/output/dense"),
                "output_layer_norm": _ln(variables, f"{base}/attention/output/LayerNorm"),
            },
            "intermediate": _dense(variables, f"{base}/intermediate/dense"),
            "output": _dense(variables, f"{base}/output/dense"),
            "output_layer_norm": _ln(variables, f"{base}/output/LayerNorm"),
        }
    # MLM head (cls/predictions); optional in fine-tune-only checkpoints
    if "cls/predictions/transform/dense/kernel" in variables:
        params["mlm"] = {
            "transform": _dense(variables, "cls/predictions/transform/dense"),
            "transform_layer_norm": _ln(variables, "cls/predictions/transform/LayerNorm"),
            "output_bias": np.asarray(variables["cls/predictions/output_bias"]),
        }
    else:  # a fresh head, from the port's own initializer (seed 0)
        fresh = init_params(config, torch.Generator().manual_seed(0), device="cpu")
        params["mlm"] = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict)
                             else v.numpy()) for k, v in fresh["mlm"].items()}
    return config, params


def load_npz(path: str) -> tuple[BertConfig, dict]:
    """npz of {tf_name (with '/'→'__slash__' escaping or raw): array}."""
    data = np.load(path, allow_pickle=False)
    variables = {}
    for key in data.files:
        variables[key.replace("__slash__", "/")] = data[key]
    return map_variables(variables)


def export_variables(params: dict, config: BertConfig) -> dict[str, np.ndarray]:
    """Inverse mapping (ours → TF names) — round-trip testing + exporting
    fine-tuned weights back to the TF ecosystem."""
    out: dict[str, np.ndarray] = {}
    emb = params["embeddings"]
    out["bert/embeddings/word_embeddings"] = np.asarray(emb["word_embeddings"])
    out["bert/embeddings/position_embeddings"] = np.asarray(emb["position_embeddings"])
    out["bert/embeddings/token_type_embeddings"] = np.asarray(emb["token_type_embeddings"])
    out["bert/embeddings/LayerNorm/gamma"] = np.asarray(emb["layer_norm"]["gamma"])
    out["bert/embeddings/LayerNorm/beta"] = np.asarray(emb["layer_norm"]["beta"])
    for i in range(config.num_layers):
        lp = params["encoder"][f"layer_{i}"]
        base = f"bert/encoder/layer_{i}"
        for tf_name, ours in [
            (f"{base}/attention/self/query", lp["attention"]["query"]),
            (f"{base}/attention/self/key", lp["attention"]["key"]),
            (f"{base}/attention/self/value", lp["attention"]["value"]),
            (f"{base}/attention/output/dense", lp["attention"]["output"]),
            (f"{base}/intermediate/dense", lp["intermediate"]),
            (f"{base}/output/dense", lp["output"]),
        ]:
            out[f"{tf_name}/kernel"] = np.asarray(ours["kernel"])
            out[f"{tf_name}/bias"] = np.asarray(ours["bias"])
        out[f"{base}/attention/output/LayerNorm/gamma"] = np.asarray(
            lp["attention"]["output_layer_norm"]["gamma"])
        out[f"{base}/attention/output/LayerNorm/beta"] = np.asarray(
            lp["attention"]["output_layer_norm"]["beta"])
        out[f"{base}/output/LayerNorm/gamma"] = np.asarray(lp["output_layer_norm"]["gamma"])
        out[f"{base}/output/LayerNorm/beta"] = np.asarray(lp["output_layer_norm"]["beta"])
    out["bert/pooler/dense/kernel"] = np.asarray(params["pooler"]["kernel"])
    out["bert/pooler/dense/bias"] = np.asarray(params["pooler"]["bias"])
    out["cls/predictions/transform/dense/kernel"] = np.asarray(params["mlm"]["transform"]["kernel"])
    out["cls/predictions/transform/dense/bias"] = np.asarray(params["mlm"]["transform"]["bias"])
    out["cls/predictions/transform/LayerNorm/gamma"] = np.asarray(
        params["mlm"]["transform_layer_norm"]["gamma"])
    out["cls/predictions/transform/LayerNorm/beta"] = np.asarray(
        params["mlm"]["transform_layer_norm"]["beta"])
    out["cls/predictions/output_bias"] = np.asarray(params["mlm"]["output_bias"])
    return out
