"""The port's naive Bayes, random forest, Markov chain and binary
vectorizer against the JAX package's, on the same seeded numpy inputs.

* Naive Bayes (multinomial and categorical): parameters within rtol = atol
  = 1e-6 (float32 segment sums, the same order on the CPU), predictions
  equal.
* Random forest: the same ``default_rng(seed)`` draws the same bootstraps
  and features, and the trees agree node for node (split feature, split
  bin, leaf class) with bin edges equal. Over the cases here no split
  candidate tied within float32 rounding; ROADMAP §3 logs the rule if one
  does (a float64 arbiter must show the two candidates tie).
* Markov chain: transition probabilities and successors, in ``lax.top_k``
  tie order, equal.
* ``tests/test_models.py``'s behavioral cases, on the port.
"""

import numpy as np
import pytest
import torch

import jax

from predictionio_tpu.models import binary_vectorizer as jbv
from predictionio_tpu.models import markov_chain as jmc
from predictionio_tpu.models import naive_bayes as jnb
from predictionio_tpu.models import random_forest as jrf
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.models import binary_vectorizer as bv
from predictionio_tpu_torch.models import markov_chain as mc
from predictionio_tpu_torch.models import naive_bayes as nb
from predictionio_tpu_torch.models import random_forest as rf

CPU = DeviceContext.create(device="cpu")
NB_TOL = 1e-6


@pytest.fixture(scope="module")
def jctx():
    return MeshContext.create(devices=jax.devices()[:1])


class TestMultinomialNB:
    @pytest.mark.parametrize("seed,smoothing", [(0, 1.0), (1, 0.3), (2, 5.0)])
    def test_parameters_match_jax(self, jctx, seed, smoothing):
        rng = np.random.default_rng(seed)
        x = rng.poisson(rng.uniform(0.5, 6, 6), (300, 6)).astype(np.float32)
        y = [f"c{v}" for v in rng.integers(0, 4, 300)]
        got = nb.train_multinomial_nb(CPU, x, y, smoothing)
        ref = jnb.train_multinomial_nb(jctx, x, y, smoothing)
        np.testing.assert_allclose(got.log_theta, ref.log_theta, rtol=NB_TOL, atol=NB_TOL)
        np.testing.assert_allclose(got.log_prior, ref.log_prior, rtol=NB_TOL, atol=NB_TOL)
        assert dict(got.label_map.items()) == dict(ref.label_map.items())
        for row in x[:50]:
            assert got.predict(row) == ref.predict(row)

    def test_separable_classes(self):
        rng = np.random.default_rng(0)
        xa = rng.poisson([5, 5, 0.5, 0.5], (200, 4))
        xb = rng.poisson([0.5, 0.5, 5, 5], (200, 4))
        x = np.vstack([xa, xb]).astype(np.float32)
        y = ["A"] * 200 + ["B"] * 200
        model = nb.train_multinomial_nb(CPU, x, y)
        assert model.predict(np.array([6, 4, 0, 1], np.float32)) == "A"
        assert model.predict(np.array([0, 1, 7, 4], np.float32)) == "B"
        assert np.mean([model.predict(x[i]) == y[i] for i in range(0, 400, 10)]) > 0.95

    def test_priors_reflect_imbalance(self):
        model = nb.train_multinomial_nb(CPU, np.ones((30, 2), np.float32),
                                        ["maj"] * 25 + ["min"] * 5)
        assert model.log_prior[model.label_map["maj"]] > model.log_prior[model.label_map["min"]]


class TestCategoricalNB:
    POINTS = [("spam", ["offer", "night"]), ("spam", ["offer", "day"]),
              ("ham", ["meeting", "day"]), ("ham", ["meeting", "night"]),
              ("ham", ["lunch", "day"])]

    def test_tables_match_jax(self, jctx):
        rng = np.random.default_rng(4)
        points = [(str(rng.choice(["a", "b", "c"])),
                   [str(rng.choice(["x", "y", "z", "w"])), str(rng.choice(["p", "q"]))])
                  for _ in range(200)] + self.POINTS
        got = nb.train_categorical_nb(CPU, points)
        ref = jnb.train_categorical_nb(jctx, points)
        np.testing.assert_allclose(got.log_prior, ref.log_prior, rtol=NB_TOL, atol=NB_TOL)
        for a, b in zip(got.log_likelihood, ref.log_likelihood):
            np.testing.assert_allclose(a, b, rtol=NB_TOL, atol=NB_TOL)
        for _, feats in points[:40]:
            assert got.predict(feats) == ref.predict(feats)

    def test_predict_and_unseen_value(self):
        model = nb.train_categorical_nb(CPU, self.POINTS)
        assert model.predict(["offer", "day"]) == "spam"
        assert model.predict(["meeting", "night"]) == "ham"
        assert model.log_score(["never-seen", "day"]) is None
        assert model.predict(["never-seen", "day"]) in ("spam", "ham")


def rf_case(seed, n=300, f=4, classes=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = [f"c{int(v)}" for v in np.floor((x[:, 0] + 0.5 * x[:, 1]) * classes) % classes]
    return x, y


class TestRandomForest:
    @pytest.mark.parametrize("seed,cfg", [
        (0, dict(n_trees=6, max_depth=4, n_bins=16)),
        (1, dict(n_trees=5, max_depth=5, n_bins=32, feature_fraction=0.5, seed=7)),
        (2, dict(n_trees=4, max_depth=3, n_bins=8, feature_fraction=0.75, seed=3)),
        (3, dict(n_trees=8, max_depth=6, n_bins=24, seed=11)),
    ])
    def test_trees_match_jax_node_for_node(self, jctx, seed, cfg):
        x, y = rf_case(seed, classes=2 + seed % 3)
        got = rf.train_random_forest(CPU, x, y, rf.RFConfig(**cfg))
        ref = jrf.train_random_forest(jctx, x, y, jrf.RFConfig(**cfg))
        for name in ("split_feature", "split_bin", "leaf_class", "bin_edges"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
        for row in x[:60]:
            assert got.predict(row) == ref.predict(row)

    def test_xor_nonlinear(self):
        rng = np.random.default_rng(1)
        x = rng.uniform(-1, 1, (400, 2)).astype(np.float32)
        y = ["pos" if (a > 0) != (b > 0) else "neg" for a, b in x]
        model = rf.train_random_forest(CPU, x, y, rf.RFConfig(n_trees=15, max_depth=4, n_bins=16))
        test = np.array([[0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [-0.5, -0.5]], np.float32)
        assert [model.predict(t) for t in test] == ["pos", "pos", "neg", "neg"]

    def test_majority_fallback_constant_labels(self):
        x = np.random.default_rng(2).uniform(size=(50, 3)).astype(np.float32)
        model = rf.train_random_forest(CPU, x, ["only"] * 50, rf.RFConfig(n_trees=3))
        assert model.predict(x[0]) == "only"

    def test_grow_tree_takes_the_first_of_tied_candidates(self):
        """Two features that split the labels identically tie exactly; the
        first (lower feature index) wins, as ``jnp.argmin`` picks it."""
        xb = torch.tensor([[0, 0], [0, 0], [1, 1], [1, 1]], dtype=torch.int32)
        y = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
        sf, sb, lc = rf._grow_tree(xb, y, torch.tensor([True, True]), 1, 2, 2, 1)
        assert sf.tolist() == [0] and sb.tolist() == [0] and lc.tolist() == [0, 1]


class TestMarkovChain:
    def test_transition_probs(self):
        model = mc.train_markov_chain(CPU, np.array([0, 0, 0, 1, 1, 2]),
                                      np.array([1, 1, 2, 0, 2, 2]), n_states=3, top_n=2)
        idx, p = model.transition(0)
        assert idx[0] == 1 and p[0] == pytest.approx(2 / 3)
        assert idx[1] == 2 and p[1] == pytest.approx(1 / 3)

    @pytest.mark.parametrize("seed", range(3))
    def test_matches_jax_ties_included(self, jctx, seed):
        rng = np.random.default_rng(seed)
        frm, to = rng.integers(0, 15, 200), rng.integers(0, 15, 200)
        got = mc.train_markov_chain(CPU, frm, to, 15, top_n=6)
        ref = jmc.train_markov_chain(jctx, frm, to, 15, top_n=6)
        np.testing.assert_array_equal(got.top_states, ref.top_states)
        np.testing.assert_array_equal(got.top_probs, ref.top_probs)

    def test_too_many_states_raise(self):
        with pytest.raises(ValueError, match="int32"):
            mc.train_markov_chain(CPU, np.zeros(1), np.zeros(1), 50_000)


class TestBinaryVectorizer:
    def test_fit_transform_matches_jax(self):
        rows = [{"color": "red", "size": "L"}, {"color": "blue"}, {"size": "S", "x": "1"}]
        got = bv.BinaryVectorizer.fit(rows, ["color", "size"])
        ref = jbv.BinaryVectorizer.fit(rows, ["color", "size"])
        assert dict(got.index.items()) == dict(ref.index.items()) and got.width == 4
        np.testing.assert_array_equal(got.transform_many(rows), ref.transform_many(rows))
        x = got.transform({"color": "red", "size": "L"})
        assert x.sum() == 2 and x[got.index["color=red"]] == 1
        assert got.transform({"color": "green"}).sum() == 0
        assert got.transform_many([]).shape == (0, 4)
