"""The port's numpy metrics against the JAX package's scikit-learn-backed
ones (``msclip_tpu/utils/metrics.py``), on the same inputs, to 1e-12 (the
metrics are in percent; sums in another order may differ in the last
digits of a float64)."""

import subprocess
import sys
import warnings
import zlib

import numpy as np
import pytest

from msclip_torch.utils import metrics as P
from msclip_tpu.utils import metrics as J

from torch_transfer_fixtures import REPO

TOL = 1e-12


def _multilabel(case, rng, n=64, c=6):
    y = (rng.random((n, c)) < 0.3).astype(np.int64)
    y[np.arange(n), rng.integers(0, c, n)] = 1
    scores = rng.standard_normal((n, c)).astype(np.float32)
    if case == "ties":
        scores = np.round(np.clip(scores, -1, 1)).astype(np.float32)
        assert len(np.unique(scores)) == 3
    elif case == "no_positive_column":
        y[:, 2] = 0
    elif case == "all_positive_column":
        y[:, 4] = 1
    elif case == "single_sample_ties":
        scores[:, 1] = 0.5  # one threshold for the whole column
    return y, scores


@pytest.mark.parametrize("case", ["random", "ties", "no_positive_column",
                                  "all_positive_column",
                                  "single_sample_ties"])
def test_map_11points_matches_sklearn(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    y, scores = _multilabel(case, rng)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # scikit-learn on empty columns
        want = J.multilabel_map_11points(y, scores)
        per_class = [J.map_11points(y[:, c], scores[:, c])
                     for c in range(y.shape[1])]
    got = P.multilabel_map_11points(y, scores)
    assert abs(got - want) <= TOL, (got, want)
    for c in range(y.shape[1]):
        assert abs(P.map_11points(y[:, c], scores[:, c])
                   - per_class[c]) <= TOL


def test_precision_recall_curve_matches_sklearn():
    """The curve itself: one point per distinct score, recall decreasing,
    the closing (1, 0); a column with no positive gives recall 1."""
    from sklearn.metrics import precision_recall_curve

    rng = np.random.default_rng(0)
    for y in (rng.integers(0, 2, 40), np.zeros(40, np.int64),
              np.ones(40, np.int64)):
        s = np.round(rng.standard_normal(40), 1).astype(np.float32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want_p, want_r, _ = precision_recall_curve(y, s)
        got_p, got_r = P.precision_recall_curve(y, s)
        np.testing.assert_array_equal(got_p, want_p)
        np.testing.assert_array_equal(got_r, want_r)


@pytest.mark.parametrize("case", ["random", "absent_predicted_class",
                                  "absent_true_class", "ties"])
def test_mean_per_class_matches_sklearn(case):
    rng = np.random.default_rng(len(case))
    n, c = 80, 7
    y = rng.integers(0, c, n)
    logits = rng.standard_normal((n, c))
    if case == "absent_predicted_class":
        y[y == 3] = 0  # class 3 is predicted but never true
        logits[:5, 3] = 10.0
    elif case == "absent_true_class":
        y[y == 5] = 6
    elif case == "ties":
        logits = np.round(logits)  # argmax picks the first of a tie
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = J.mean_per_class_accuracy(y, logits)
    got = P.mean_per_class_accuracy(y, logits)
    assert abs(got - want) <= TOL, (got, want)


@pytest.mark.parametrize("case", ["random", "ties", "few_distinct",
                                  "perfect", "labels_1_2"])
def test_roc_auc_matches_sklearn(case):
    rng = np.random.default_rng(len(case) + 7)
    n = 50
    y = rng.integers(0, 2, n)
    logits = rng.standard_normal((n, 2)).astype(np.float32)
    if case == "ties":
        logits = np.round(logits, 1)
    elif case == "few_distinct":
        logits[:, 1] = rng.integers(0, 3, n)
    elif case == "perfect":
        logits[:, 1] = y + 0.1 * rng.random(n)
    elif case == "labels_1_2":
        y = y + 1
    got = P.roc_auc(y, logits)
    want = J.roc_auc(y, logits)
    assert abs(got - want) <= TOL, (got, want)


def test_roc_auc_of_one_class_is_nan_in_both():
    """With one class in ``y`` the area is not defined: scikit-learn (1.9)
    warns and returns NaN, and the port does the same."""
    y = np.ones(6, np.int64)
    logits = np.random.default_rng(0).standard_normal((6, 2))
    with pytest.warns(Warning, match="Only one class"):
        want = J.roc_auc(y, logits)
    with pytest.warns(RuntimeWarning, match="Only one class"):
        got = P.roc_auc(y, logits)
    assert np.isnan(got) and np.isnan(want)
    with pytest.raises(ValueError, match="binary"):
        P.roc_auc(np.arange(6) % 3, logits)


def test_port_metrics_import_no_sklearn():
    """The port's eval imports scikit-learn only inside
    ``fit_linear_probe_sklearn``: the card's machine has none."""
    code = ("import sys\n"
            "import msclip_torch.utils.metrics, msclip_torch.eval.zero_shot\n"
            "import msclip_torch.eval.linear_probe, msclip_torch.eval.retrieval\n"
            "import msclip_torch.tools.linear_probe\n"
            "assert not any(m.startswith('sklearn') for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
