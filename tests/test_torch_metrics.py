"""The port's numpy metrics against the JAX package's scikit-learn ones:
binary and multiclass, ties, absent classes, both probability maps, the
confusion matrix and the report text. The port must not import
scikit-learn to compute them. Tolerance 1e-12: the same rational numbers,
summed in another order in float64.
"""

import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from raindrop_tpu.train import metrics as jm

from raindrop_tpu_torch.train import metrics as tm

TOL = 1e-12


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


def _logits(rng, n, c, ties):
    logits = rng.normal(size=(n, c)).astype(np.float32)
    if ties:     # few distinct values: many tied scores
        logits = np.round(logits * 2) / 2
    return logits


@pytest.mark.parametrize("prob_mode", ["softmax", "sigmoid"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [7, 60, 401])
def test_binary_metrics_equal_sklearn(n, ties, prob_mode):
    rng = np.random.default_rng(n)
    logits = _logits(rng, n, 2, ties)
    y = (rng.uniform(size=n) < 0.3).astype(np.int64)
    y[:2] = [0, 1]
    _close(tm.classification_metrics(logits, y, 2, prob_mode=prob_mode),
           jm.classification_metrics(logits, y, 2, prob_mode=prob_mode))


@pytest.mark.parametrize("prob_mode", ["softmax", "sigmoid"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("absent", [(), (3,), (0, 5, 7)])
def test_multiclass_metrics_equal_sklearn(absent, ties, prob_mode):
    """8 classes as PAM has; `absent` classes never occur in y (a class
    that is predicted but absent enters the macro averages with zeros)."""
    rng = np.random.default_rng(len(absent))
    n, c = 120, 8
    present = [k for k in range(c) if k not in absent]
    y = rng.choice(present, size=n)
    logits = _logits(rng, n, c, ties)
    logits[np.arange(n), y] += 0.8          # some signal
    _close(tm.classification_metrics(logits, y, c, prob_mode=prob_mode),
           jm.classification_metrics(logits, y, c, prob_mode=prob_mode))


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(4, 80), st.integers(2, 6),
       st.booleans())
def test_metrics_equal_sklearn_on_random_cases(seed, n, c, ties):
    rng = np.random.default_rng(seed)
    logits = _logits(rng, n, c, ties)
    y = rng.integers(0, c, size=n)
    y[:2] = [0, 1]                       # both classes of a binary problem
    if c > 2 and len(np.unique(y)) == c and n >= 2 * c:
        y[y == c - 1] = 0                # sometimes an absent class
    _close(tm.classification_metrics(logits, y, c),
           jm.classification_metrics(logits, y, c))


def test_probability_maps_and_one_hot_equal():
    logits = np.random.default_rng(0).normal(size=(9, 4)).astype(np.float32) * 30
    np.testing.assert_array_equal(tm.softmax_probs(logits), jm.softmax_probs(logits))
    np.testing.assert_array_equal(tm.binary_probs_sigmoid(logits),
                                  jm.binary_probs_sigmoid(logits))
    y = np.array([0, 3, 1, 1])
    np.testing.assert_array_equal(tm.one_hot(y, 4), jm.one_hot(y, 4))


@pytest.mark.parametrize("labels", [[0, 1], list(range(8)), [2, 0]])
def test_confusion_matrix_equals_the_jax_package(labels):
    rng = np.random.default_rng(1)
    y, yp = rng.integers(0, 8, size=200), rng.integers(0, 8, size=200)
    np.testing.assert_array_equal(tm.confusion_matrix_np(y, yp, labels),
                                  jm.confusion_matrix_np(y, yp, labels))


@pytest.mark.parametrize("case", ["binary", "multiclass", "never_predicted",
                                  "wide_labels"])
def test_report_text_equals_sklearn(case):
    rng = np.random.default_rng(2)
    if case == "binary":
        y, yp = rng.integers(0, 2, size=50), rng.integers(0, 2, size=50)
    elif case == "multiclass":
        y, yp = rng.integers(0, 8, size=300), rng.integers(0, 8, size=300)
    elif case == "never_predicted":     # zero_division=0 rows
        y, yp = rng.integers(0, 4, size=40), rng.integers(0, 2, size=40)
    else:                               # labels wider than 'weighted avg'
        y = rng.integers(0, 2, size=30) * 1234567890123 + 5
        yp = rng.integers(0, 2, size=30) * 1234567890123 + 5
    assert tm.classification_report_str(y, yp) == jm.classification_report_str(y, yp)


@pytest.mark.filterwarnings("ignore")
def test_one_class_only_gives_an_undefined_auroc_as_sklearn_does():
    logits = np.random.default_rng(0).normal(size=(5, 2)).astype(np.float32)
    y = np.ones(5, np.int64)
    got = tm.classification_metrics(logits, y, 2)
    want = jm.classification_metrics(logits, y, 2)
    assert np.isnan(got["auroc"]) and np.isnan(want["auroc"])
    assert abs(got["auprc"] - want["auprc"]) <= TOL


def test_the_port_computes_them_without_sklearn():
    code = ("import sys\n"
            "sys.modules['sklearn'] = None\n"
            "import numpy as np\n"
            "from raindrop_tpu_torch.train.metrics import (\n"
            "    classification_metrics, classification_report_str)\n"
            "y = np.array([0, 1, 2, 1, 0, 2])\n"
            "m = classification_metrics(np.eye(3)[y] + 0.1, y, 3)\n"
            "assert m['auroc'] == 1.0 and m['f1'] == 1.0, m\n"
            "classification_report_str(y, y)\n"
            "assert not [k for k in sys.modules if k.startswith('sklearn.')]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
