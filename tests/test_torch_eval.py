"""The port's ``eval/`` against the JAX package's, on the CPU, and both
networks' ``evaluate*`` against the JAX networks' on the same weights.

The same numpy inputs from a seed go to the JAX classes as arrays and to
the port's as tensors (the port takes a tensor to the host once a batch).
Counts (confusion matrices, tp/fp/tn/fn, histograms) must be equal, every
float within 1e-12 (the same numpy code on the same float64 values), and
the ``stats()`` text equal.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.eval import calibration as JC
from deeplearning4j_tpu.eval import classification as JE
from deeplearning4j_tpu.eval import regression as JR
from deeplearning4j_tpu.eval import roc as JROC
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import eval as TEV
from deeplearning4j_tpu_torch.eval import calibration as TC
from deeplearning4j_tpu_torch.eval import classification as TE
from deeplearning4j_tpu_torch.eval import regression as TR
from deeplearning4j_tpu_torch.eval import roc as TROC
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.graph import GraphBuilder as TGB
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import serialization as tser

FTOL = 1e-12


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _cls_batch(rs, n, c, t=None, ties=False, empty=()):
    """One-hot labels (never of the ``empty`` classes) and probabilities;
    ``ties`` rounds probabilities so the true class ties with others."""
    shape = (n,) if t is None else (n, t)
    pool = [k for k in range(c) if k not in empty]
    labels = np.eye(c)[rs.choice(pool, size=shape)]
    probs = _softmax(rs.randn(*shape, c))
    if ties:
        probs = np.round(probs * 4) / 4
    return labels, probs


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _same(got, want, what=""):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _same(g, w, what)
        return
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}[{k}]")
        return
    if isinstance(want, str):
        assert got == want, what
        return
    w = np.asarray(want)
    if w.dtype.kind in "iub":
        np.testing.assert_array_equal(np.asarray(got), w, err_msg=what)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), w.astype(np.float64), rtol=0,
                                   atol=FTOL, err_msg=what)


def _feed(j, t, batches):
    """The same batches, numpy to the JAX object and tensors to the port's."""
    for labels, probs, mask in batches:
        j.eval(labels, probs, mask=mask)
        t.eval(_t(labels), _t(probs), mask=_t(mask))


def _evaluation_metrics(e):
    c = e.confusion.n_classes
    out = {"matrix": e.confusion.matrix, "accuracy": e.accuracy(),
           "top_n": e.top_n_accuracy(), "stats": e.stats(),
           "far": e.false_alarm_rate(), "csv": e.confusion.to_csv(),
           "html": e.confusion.to_html(), "confusion": e.confusion_to_string()}
    for avg in ("macro", "micro"):
        for m in ("precision", "recall", "f1", "false_positive_rate", "false_negative_rate",
                  "matthews_correlation", "g_measure"):
            out[f"{m}_{avg}"] = getattr(e, m)(averaging=avg)
    for k in range(c):
        for m in ("precision", "recall", "f1", "false_positive_rate", "false_negative_rate",
                  "matthews_correlation", "g_measure"):
            out[f"{m}_{k}"] = getattr(e, m)(k)
        out[f"counts_{k}"] = [e.true_positives(k), e.false_positives(k), e.true_negatives(k),
                              e.false_negatives(k), e.class_count(k)]
    out["excluded"] = [e.average_precision_num_classes_excluded(),
                       e.average_recall_num_classes_excluded(),
                       e.average_f1_num_classes_excluded()]
    return out


EVAL_CASES = {
    "plain": (dict(), dict(n=40, c=4)),
    "masked_time_series": (dict(), dict(n=6, c=3, t=5, mask=True)),
    "top3_ties": (dict(top_n=3), dict(n=50, c=5, ties=True)),
    "cost_array": (dict(cost_array=[1.0, 2.0, 0.5, 1.5]), dict(n=40, c=4)),
    "empty_classes": (dict(n_classes=5), dict(n=30, c=5, empty=(1, 3))),
    "binary_threshold": (dict(binary_decision_threshold=0.3), dict(n=40, c=2)),
    "binary_single_column": (dict(binary_decision_threshold=0.4), dict(n=40, c=1)),
    "labelled": (dict(labels=["cat", "dog", "owl"]), dict(n=30, c=3)),
}


def _batches(rs, n, c, t=None, ties=False, empty=(), mask=False, parts=3):
    out = []
    for _ in range(parts):
        if c == 1:
            labels = (rs.rand(n, 1) > 0.5).astype(np.float64)
            probs = rs.rand(n, 1)
        else:
            labels, probs = _cls_batch(rs, n, c, t, ties, empty)
        m = (rs.rand(n, t) > 0.3).astype(np.float64) if mask else None
        out.append((labels, probs, m))
    return out


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_evaluation_matches_jax(case):
    kw, data = EVAL_CASES[case]
    batches = _batches(np.random.RandomState(len(case)), **data)
    j, t = JE.Evaluation(**kw), TE.Evaluation(**kw)
    _feed(j, t, batches)
    _same(_evaluation_metrics(t), _evaluation_metrics(j), case)
    # merge: two halves into one equals the whole
    j2, t2 = JE.Evaluation(**kw), TE.Evaluation(**kw)
    ja, ta = JE.Evaluation(**kw), TE.Evaluation(**kw)
    _feed(j2, t2, batches[:1])
    _feed(ja, ta, batches[1:])
    j2.merge(ja)
    t2.merge(ta)
    _same(_evaluation_metrics(t2), _evaluation_metrics(j), f"{case} merged")


def test_evaluation_meta_and_prediction_lists_match_jax():
    rs = np.random.RandomState(3)
    labels, probs = _cls_batch(rs, 12, 3)
    meta = [f"row{i}" for i in range(12)]
    j, t = JE.Evaluation(), TE.Evaluation()
    j.eval(labels, probs, record_meta_data=meta)
    t.eval(_t(labels), _t(probs), record_meta_data=meta)
    assert [tuple(p) for p in t.get_prediction_errors()] == \
        [tuple(p) for p in j.get_prediction_errors()]
    for k in range(3):
        assert [tuple(p) for p in t.get_predictions_by_actual_class(k)] == \
            [tuple(p) for p in j.get_predictions_by_actual_class(k)]
    j.eval_single(2, 0)
    t.eval_single(2, 0)
    _same(t.confusion.matrix, j.confusion.matrix)


@pytest.mark.parametrize("roc_steps", [None, 0, 10])
def test_evaluation_binary_matches_jax(roc_steps):
    rs = np.random.RandomState(5)
    kw = dict(thresholds=np.array([0.3, 0.5, 0.7]), roc_binary_steps=roc_steps)
    j, t = JE.EvaluationBinary(**kw), TE.EvaluationBinary(**kw)
    batches = [((rs.rand(20, 3) > 0.5).astype(np.float64), rs.rand(20, 3), None)
               for _ in range(2)]
    _feed(j, t, batches)
    for k in range(3):
        for m in ("accuracy", "precision", "recall", "f1", "g_measure", "matthews_correlation",
                  "false_positive_rate", "false_negative_rate", "total_count"):
            _same(getattr(t, m)(k), getattr(j, m)(k), f"{m}({k})")
        if roc_steps is not None:
            _same(t.auc(k), j.auc(k), f"auc({k})")
    assert t.stats() == j.stats()
    for m in ("tp", "fp", "tn", "fn"):
        _same(getattr(t, m), getattr(j, m), m)


def test_regression_evaluation_matches_jax():
    rs = np.random.RandomState(7)
    j, t = JR.RegressionEvaluation(column_names=["a", "b"]), \
        TR.RegressionEvaluation(column_names=["a", "b"])
    batches = [(rs.randn(4, 6, 2), rs.randn(4, 6, 2), (rs.rand(4, 6) > 0.3).astype(np.float64))
               for _ in range(3)]
    _feed(j, t, batches)
    for col in (0, 1):
        for m in ("mean_squared_error", "mean_absolute_error", "root_mean_squared_error",
                  "relative_squared_error", "pearson_correlation", "r_squared"):
            _same(getattr(t, m)(col), getattr(j, m)(col), f"{m}({col})")
    for m in ("average_mean_squared_error", "average_mean_absolute_error", "average_r_squared"):
        _same(getattr(t, m)(), getattr(j, m)(), m)
    assert t.stats() == j.stats()


def _roc_metrics(r):
    out = {"auc": r.auc(), "stats": r.stats(), "roc": r.roc_curve(), "n": [r.n_pos, r.n_neg]}
    if r.exact:
        out["auprc"] = r.auprc()
        out["pr"] = r.precision_recall_curve()
    return out


@pytest.mark.parametrize("steps", [0, 10])
@pytest.mark.parametrize("layout", ["column", "two_columns", "time_series_masked"])
def test_roc_matches_jax_and_merges(steps, layout):
    rs = np.random.RandomState(11 + steps)
    batches = []
    for _ in range(3):
        if layout == "column":
            batches.append(((rs.rand(30) > 0.4).astype(np.float64), np.round(rs.rand(30), 2),
                            None))
        elif layout == "two_columns":
            lab, prob = _cls_batch(rs, 30, 2, ties=True)
            batches.append((lab, prob, None))
        else:
            lab, prob = _cls_batch(rs, 5, 2, t=6)
            batches.append((lab, prob, (rs.rand(5, 6) > 0.3).astype(np.float64)))
    j, t = JROC.ROC(steps), TROC.ROC(steps)
    _feed(j, t, batches)
    _same(_roc_metrics(t), _roc_metrics(j), "roc")
    ja, ta, jb, tb = JROC.ROC(steps), TROC.ROC(steps), JROC.ROC(steps), TROC.ROC(steps)
    _feed(ja, ta, batches[:2])
    _feed(jb, tb, batches[2:])
    ja.merge(jb)
    ta.merge(tb)
    _same(_roc_metrics(ta), _roc_metrics(ja), "merged")
    _same(ta.auc(), t.auc(), "merged vs whole")
    ta.reset()
    assert ta.n_pos == ta.n_neg == 0


@pytest.mark.parametrize("steps", [0, 10])
def test_roc_binary_and_multiclass_match_jax(steps):
    rs = np.random.RandomState(13)
    lab, prob = _cls_batch(rs, 40, 4)
    for jcls, tcls in ((JROC.ROCBinary, TROC.ROCBinary), (JROC.ROCMultiClass, TROC.ROCMultiClass)):
        j, t = jcls(steps), tcls(steps)
        _feed(j, t, [(lab[:20], prob[:20], None)])
        jb, tb = jcls(steps), tcls(steps)
        _feed(jb, tb, [(lab[20:], prob[20:], None)])
        j.merge(jb)
        t.merge(tb)
        for k in range(4):
            _same(t.auc(k), j.auc(k), f"{jcls.__name__} auc({k})")
        _same(t.average_auc(), j.average_auc(), "average")


def test_calibration_matches_jax():
    rs = np.random.RandomState(17)
    batches = []
    for _ in range(3):
        lab, prob = _cls_batch(rs, 4, 3, t=5)
        batches.append((lab, prob, (rs.rand(4, 5) > 0.2).astype(np.float64)))
    j, t = JC.EvaluationCalibration(8, 20), TC.EvaluationCalibration(8, 20)
    _feed(j, t, batches[:2])
    jb, tb = JC.EvaluationCalibration(8, 20), TC.EvaluationCalibration(8, 20)
    _feed(jb, tb, batches[2:])
    j.merge(jb)
    t.merge(tb)

    def metrics(e):
        out = {"stats": e.stats(), "ece": e.expected_calibration_error(),
               "labels": e.get_label_counts_each_class(),
               "preds": e.get_prediction_counts_each_class(),
               "resid_all": vars(e.get_residual_plot_all_classes()),
               "hist_all": vars(e.get_probability_histogram_all_classes())}
        for k in range(e.num_classes()):
            out[f"rd{k}"] = vars(e.get_reliability_diagram(k))
            out[f"ece{k}"] = e.expected_calibration_error(k)
            out[f"resid{k}"] = vars(e.get_residual_plot(k))
            out[f"hist{k}"] = vars(e.get_probability_histogram(k))
        return out

    _same(metrics(t), metrics(j), "calibration")


def test_bf16_and_package_exports():
    assert {n for n in dir(TEV) if not n.startswith("_")} >= {
        "Evaluation", "ConfusionMatrix", "EvaluationBinary", "RegressionEvaluation", "ROC",
        "ROCBinary", "ROCMultiClass", "EvaluationCalibration"}
    rs = np.random.RandomState(19)
    lab, prob = _cls_batch(rs, 16, 4)
    t = TE.Evaluation()
    t.eval(_t(lab).bfloat16(), _t(prob).bfloat16())
    j = JE.Evaluation()
    j.eval(lab, np.asarray(torch.from_numpy(prob).bfloat16().float().numpy()))
    _same(t.confusion.matrix, j.confusion.matrix)


# ---------------------------------------------------------------------------
# the networks' evaluate family
# ---------------------------------------------------------------------------

def _mlp(C, L, I):
    return C(seed=3).list(L.DenseLayer(n_out=8, activation="tanh"),
                          L.OutputLayer(n_out=3, loss="mcxent"),
                          input_type=I.FeedForwardType(5))


def test_mln_evaluate_family_matches_jax():
    jnet = JNet(_mlp(JConf, JL, JI))
    jnet.init()
    tnet = tser.params_from_numpy(TNet(_mlp(TConf, TL, TI), device="cpu"),
                                  [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params])
    rs = np.random.RandomState(23)
    x = rs.randn(20, 5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 20)]
    je, te = jnet.evaluate(x, y, batch_size=8), tnet.evaluate(x, y, batch_size=8)
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
    assert te.stats() == je.stats()
    te2 = tnet.evaluate((torch.from_numpy(x), torch.from_numpy(y)), batch_size=7)
    np.testing.assert_array_equal(te2.confusion.matrix, je.confusion.matrix)
    np.testing.assert_allclose(tnet.evaluate_roc(x, y).average_auc(),
                               jnet.evaluate_roc(x, y).average_auc(), atol=1e-6)
    np.testing.assert_allclose(tnet.evaluate_roc(x, y, threshold_steps=10).average_auc(),
                               jnet.evaluate_roc(x, y, threshold_steps=10).average_auc(),
                               atol=1e-6)
    jr, tr = jnet.evaluate_regression(x, y), tnet.evaluate_regression(x, y)
    np.testing.assert_allclose(tr.average_mean_squared_error(), jr.average_mean_squared_error(),
                               rtol=1e-5)
    np.testing.assert_array_equal(tnet.predict(x), jnet.predict(x))
    np.testing.assert_allclose(tnet.f1_score(x, y), jnet.f1_score(x, y), atol=1e-12)
    # accumulating into a given instance (top-N) and an iterator of batches
    topn = tnet.evaluate(x, y, evaluation=TE.Evaluation(top_n=2))
    assert topn.top_n_accuracy() == jnet.evaluate(
        x, y, evaluation=JE.Evaluation(top_n=2)).top_n_accuracy()
    def it():
        return ((x[i:i + 5], y[i:i + 5]) for i in range(0, 20, 5))

    np.testing.assert_array_equal(tnet.evaluate(it()).confusion.matrix,
                                  jnet.evaluate(it()).confusion.matrix)
    with pytest.raises(ValueError, match="no data"):
        tnet.evaluate_roc(iter(()))


def _two_head_graph(GB, L, I):
    g = GB(seed=5)
    g.add_inputs("a", "b")
    g.set_input_types(I.FeedForwardType(4), I.FeedForwardType(3))
    g.add_layer("ha", L.DenseLayer(n_out=6, activation="tanh"), "a")
    g.add_layer("hb", L.DenseLayer(n_out=6, activation="tanh"), "b")
    g.add_layer("cls", L.OutputLayer(n_out=4, loss="mcxent"), "ha")
    g.add_layer("bin", L.OutputLayer(n_out=2, loss="mcxent"), "hb")
    g.set_outputs("cls", "bin")
    return g.build()


def test_graph_evaluate_family_matches_jax_per_head():
    jnet = JGraph(_two_head_graph(JGB, JL, JI))
    jnet.init()
    tnet = tser.params_from_numpy(
        TGraph(_two_head_graph(TGB, TL, TI), device="cpu"),
        {n: {k: np.asarray(v) for k, v in p.items()} for n, p in jnet.params.items()})
    rs = np.random.RandomState(29)
    x = {"a": rs.randn(18, 4).astype(np.float32), "b": rs.randn(18, 3).astype(np.float32)}
    y = {"cls": np.eye(4, dtype=np.float32)[rs.randint(0, 4, 18)],
         "bin": np.eye(2, dtype=np.float32)[rs.randint(0, 2, 18)]}
    for head in ("cls", "bin"):
        je = jnet.evaluate(x, y, batch_size=5, output_name=head)
        te = tnet.evaluate(x, y, batch_size=5, output_name=head)
        np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
        assert te.stats() == je.stats()
        jr = jnet.evaluate_roc(x, y, output_name=head)
        tr = tnet.evaluate_roc(x, y, output_name=head)
        assert type(tr).__name__ == type(jr).__name__
        np.testing.assert_allclose(
            tr.auc() if head == "bin" else tr.average_auc(),
            jr.auc() if head == "bin" else jr.average_auc(), atol=1e-6)
        np.testing.assert_allclose(
            tnet.evaluate_regression(x, y, output_name=head).average_mean_squared_error(),
            jnet.evaluate_regression(x, y, output_name=head).average_mean_squared_error(),
            rtol=1e-5)
