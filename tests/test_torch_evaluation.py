"""The port's ``evaluation/`` held to the JAX package's: the same seeded
labels and predictions, masked and not, through every class of both
packages; every statistic, every ``stats()`` string and every ``merge``
agree within 1e-12.  Then ``MultiLayerNetwork.evaluate``,
``evaluate_regression`` and ``evaluate_roc`` on the CPU against the
reference's, on the same weights and batches."""

import inspect

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import evaluation as jevaluation
from deeplearning4j_tpu.data.iterators import ArrayDataSetIterator as JArrayDataSetIterator
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork

from deeplearning4j_tpu_torch import evaluation
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration, layers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = 1e-12
N, C = 60, 4


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _inputs(kind, seed):
    """(labels, predictions) of one kind, seeded."""
    rng = np.random.default_rng(seed)
    if kind == "onehot":
        return np.eye(C)[rng.integers(0, C, N)], _softmax(rng.normal(size=(N, C)))
    if kind == "index":
        return rng.integers(0, C, (N, 1)).astype(np.float64), _softmax(rng.normal(size=(N, C)))
    if kind == "sigmoid":
        return (rng.random((N, 1)) < 0.4).astype(np.float64), rng.random((N, 1))
    if kind == "two_column":
        return np.eye(2)[rng.integers(0, 2, N)], _softmax(rng.normal(size=(N, 2)))
    if kind == "multilabel":
        return (rng.random((N, C)) < 0.5).astype(np.float64), rng.random((N, C))
    if kind == "regression":
        y = rng.normal(size=(N, 3))
        return y, y + 0.3 * rng.normal(size=(N, 3))
    if kind == "time":
        return (np.eye(C)[rng.integers(0, C, (6, 10))],
                _softmax(rng.normal(size=(6, 10, C))))
    raise ValueError(kind)


def _mask(kind, seed):
    rng = np.random.default_rng(seed + 100)
    return (rng.random((6, 10)) < 0.7).astype(np.float64) if kind == "time" else \
        (rng.random(N) < 0.7).astype(np.float64)


# class name, constructor kwargs, input kind, {method: argument lists}
IDX = [(c,) for c in range(C)]
CASES = {
    "evaluation_top1": ("Evaluation", {}, "onehot",
                        {"accuracy": [()], "top_n_accuracy": [()], "precision": [()] + IDX,
                         "recall": [()] + IDX, "f1": [()] + IDX, "gmeasure": IDX,
                         "matthews_correlation": IDX, "false_positive_rate": IDX,
                         "false_negative_rate": IDX, "confusion_matrix": [()], "stats": [()]}),
    "evaluation_top3_micro": ("Evaluation", {"top_n": 3, "labels": ["a", "b", "c", "d"]},
                              "onehot",
                              {"top_n_accuracy": [()], "stats": [()],
                               "precision": [(None, "micro")], "recall": [(None, "micro")],
                               "f1": [(None, "micro")]}),
    "evaluation_index_labels": ("Evaluation", {}, "index",
                                {"accuracy": [()], "f1": [()], "stats": [()],
                                 "confusion_matrix": [()]}),
    "evaluation_sigmoid": ("Evaluation", {}, "sigmoid",
                           {"accuracy": [()], "precision": [(0,), (1,)], "stats": [()]}),
    "evaluation_time_series": ("Evaluation", {}, "time",
                               {"accuracy": [()], "f1": [()], "stats": [()]}),
    "evaluation_binary": ("EvaluationBinary", {"threshold": 0.4}, "multilabel",
                          {"accuracy": [()] + IDX, "precision": IDX, "recall": IDX,
                           "f1": IDX}),
    "regression": ("RegressionEvaluation", {"column_names": ["u", "v", "w"]}, "regression",
                   {m: [(0,), (1,), (2,)] for m in
                    ("mean_squared_error", "mean_absolute_error", "root_mean_squared_error",
                     "relative_squared_error", "pearson_correlation", "r_squared")}
                   | {"average_mean_squared_error": [()],
                      "average_mean_absolute_error": [()], "stats": [()]}),
    "roc_exact": ("ROC", {}, "two_column", {"calculate_auc": [()], "calculate_auprc": [()]}),
    "roc_sigmoid_thresholded": ("ROC", {"threshold_steps": 20}, "sigmoid",
                                {"calculate_auc": [()], "calculate_auprc": [()]}),
    "roc_binary": ("ROCBinary", {}, "multilabel",
                   {"calculate_auc": IDX, "calculate_average_auc": [()]}),
    "roc_multiclass": ("ROCMultiClass", {"threshold_steps": 10}, "onehot",
                       {"calculate_auc": IDX, "calculate_average_auc": [()]}),
    "calibration": ("EvaluationCalibration", {"reliability_bins": 5, "histogram_bins": 8},
                    "onehot",
                    {"reliability_diagram": IDX, "expected_calibration_error": IDX,
                     "residual_plot": [()], "probability_histogram": IDX}),
}


def _assert_same(got, want, what):
    if isinstance(want, str):
        assert got == want, what
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=TOL, atol=TOL, err_msg=what)


def _run(cls_name, kwargs, kind, masked, seeds):
    out = []
    for package in (evaluation, jevaluation):
        ev = getattr(package, cls_name)(**kwargs)
        for seed in seeds:
            labels, preds = _inputs(kind, seed)
            ev.eval(labels, preds, mask=_mask(kind, seed) if masked else None)
        out.append(ev)
    return out


def _compare(got, want, methods, what):
    for name, arg_lists in methods.items():
        for args in arg_lists:
            _assert_same(getattr(got, name)(*args), getattr(want, name)(*args),
                         f"{what}.{name}{args}")


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_statistic_agrees_with_jax(case, masked):
    cls_name, kwargs, kind, methods = CASES[case]
    got, want = _run(cls_name, kwargs, kind, masked, (1, 2))
    _compare(got, want, methods, case)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if hasattr(getattr(evaluation, CASES[c][0]), "merge")))
def test_merges_agree_with_jax(case):
    cls_name, kwargs, kind, methods = CASES[case]
    merged = []
    for package in (evaluation, jevaluation):
        parts = []
        for seed in (3, 4):
            ev = getattr(package, cls_name)(**kwargs)
            labels, preds = _inputs(kind, seed)
            ev.eval(labels, preds, mask=_mask(kind, seed))
            parts.append(ev)
        merged.append(parts[0].merge(parts[1]))
    _compare(*merged, methods, f"{case} merged")
    # a merge equals one evaluation over both halves
    both, _ = _run(cls_name, kwargs, kind, True, (3, 4))
    _compare(merged[0], both, methods, f"{case} merged vs one pass")


def test_every_class_of_the_reference_is_ported():
    want = {n for n, o in inspect.getmembers(jevaluation, inspect.isclass)}
    assert want == {n for n, o in inspect.getmembers(evaluation, inspect.isclass)}
    assert {c[0] for c in CASES.values()} == want


# ------------------------------------------------------------------ nets
def _nets(n_out, activation, loss):
    """A JAX net and the port's with the same weights, seeded inputs,
    targets and a labels mask."""
    confs = []
    for nnc, itype, lay in ((JNeuralNetConfiguration, JInputType, jlayers),
                            (NeuralNetConfiguration, InputType, layers)):
        confs.append(nnc.builder().seed(11).weight_init("xavier").list()
                     .layer(lay.DenseLayer(n_out=8, activation="relu"))
                     .layer(lay.OutputLayer(n_out=n_out, activation=activation, loss=loss))
                     .set_input_type(itype.feed_forward(5)).build())
    jnet = JMultiLayerNetwork(confs[0]).init()
    net = load_jax_params(MultiLayerNetwork(confs[1], device="cpu"),
                          jax.tree_util.tree_map(np.array, jnet.params_),
                          jax.tree_util.tree_map(np.array, jnet.state_))
    rng = np.random.default_rng(n_out)
    x = rng.normal(size=(45, 5)).astype(np.float32)
    y = (rng.normal(size=(45, n_out)) if loss == "mse"
         else np.eye(n_out)[rng.integers(0, n_out, 45)]).astype(np.float32)
    lmask = (rng.random(45) < 0.8).astype(np.float32)

    def iters():
        return (ArrayDataSetIterator(x, y, 10, labels_mask=lmask),
                JArrayDataSetIterator(x, y, 10, labels_mask=lmask))
    return jnet, net, iters


@pytest.fixture(scope="module", params=[4, 2], ids=["four_classes", "two_classes"])
def classifier(request):
    return _nets(request.param, "softmax", "mcxent")


def test_net_evaluate_matches_jax(classifier):
    jnet, net, iters = classifier
    for top_n in (1, 2):
        got = net.evaluate(iters()[0], top_n=top_n)
        want = jnet.evaluate(iters()[1], top_n=top_n)
        np.testing.assert_array_equal(got.confusion_matrix(), want.confusion_matrix())
        assert got.total == want.total and got.top_n_correct == want.top_n_correct
        assert got.stats() == want.stats()


def test_net_evaluate_roc_matches_jax(classifier):
    """Two outputs give a ``ROC``, more a ``ROCMultiClass``, in both; the
    AUCs of the two nets' f32 outputs agree within 1e-6."""
    jnet, net, iters = classifier
    for steps in (0, 10):
        got = net.evaluate_roc(iters()[0], threshold_steps=steps)
        want = jnet.evaluate_roc(iters()[1], threshold_steps=steps)
        assert type(got).__name__ == type(want).__name__
        if type(want).__name__ == "ROC":
            aucs = [("calculate_auc", ()), ("calculate_auprc", ())]
        else:
            aucs = [("calculate_average_auc", ())] + [("calculate_auc", (c,)) for c in range(4)]
        for name, args in aucs:
            np.testing.assert_allclose(getattr(got, name)(*args), getattr(want, name)(*args),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{name}{args}")


def test_net_evaluate_regression_matches_jax():
    """Every column's statistics from the two nets' f32 outputs agree
    within 1e-5 relative."""
    jnet, net, iters = _nets(3, "identity", "mse")
    got = net.evaluate_regression(iters()[0])
    want = jnet.evaluate_regression(iters()[1])
    for name, arg_lists in CASES["regression"][3].items():
        if name == "stats":
            continue
        for args in arg_lists:
            np.testing.assert_allclose(getattr(got, name)(*args), getattr(want, name)(*args),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{name}{args}")
