"""The port's evaluation copies (``eval/``, ``data/trials.py``,
``runtime/experiment.py::build_evaluator``) against the JAX package's, on the
same numpy-seeded embeddings and scores: trial files, EER and minDCF
(exact on the same scores), cosine scoring with and without centering and
length-norm, AS-Norm, LDA and PLDA, and ``build_evaluator`` for every
``config/evaluator/*.yaml``; scores at rtol 1e-6 / atol 1e-7."""

import pathlib

import numpy as np
import pytest
import yaml

from w2v2_speaker_tpu.data import trials as jtrials
from w2v2_speaker_tpu.eval import backends as jbackends
from w2v2_speaker_tpu.eval import evaluator as jeval
from w2v2_speaker_tpu.eval import metrics as jmetrics
from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu_torch.data import trials as ttrials
from w2v2_speaker_tpu_torch.eval import backends as tbackends
from w2v2_speaker_tpu_torch.eval import evaluator as teval
from w2v2_speaker_tpu_torch.eval import metrics as tmetrics
from w2v2_speaker_tpu_torch.runtime import experiment as texp

ROOT = pathlib.Path(__file__).resolve().parents[1]
EVALUATORS = sorted(p.stem for p in (ROOT / "config" / "evaluator").glob("*.yaml"))
RTOL, ATOL = 1e-6, 1e-7
N_SPK, PER_SPK, DIM = 12, 6, 24


def _embeddings(seed=0):
    """[N_SPK * PER_SPK, DIM] embeddings clustered by speaker, labels, ids."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(N_SPK, DIM))
    labels = np.repeat(np.arange(N_SPK), PER_SPK)
    x = (centers[labels] + 0.7 * rng.normal(size=(len(labels), DIM))).astype(np.float32)
    ids = [f"id{lab:05d}/yt{i % 3}/{i:05d}" for i, lab in enumerate(labels)]
    return x, labels, ids


def _trial_pairs(ids, seed=0, n=80):
    by_spk = {}
    for sample_id in ids:
        by_spk.setdefault(sample_id.split("/")[0], []).append(sample_id)
    return by_spk, n, seed


@pytest.mark.parametrize("seed", [0, 1])
def test_trials_match_jax(tmp_path, seed):
    _, _, ids = _embeddings(seed)
    by_spk, n, s = _trial_pairs(ids, seed)
    got = ttrials.generate_validation_pairs(by_spk, n, s)
    want = jtrials.generate_validation_pairs(by_spk, n, s)
    assert [(p.same_speaker, p.sample1_id, p.sample2_id) for p in got] == [
        (p.same_speaker, p.sample1_id, p.sample2_id) for p in want]
    ttrials.save_evaluation_pairs(got, tmp_path / "t.txt")
    jtrials.save_evaluation_pairs(want, tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    loaded = ttrials.load_evaluation_pairs(tmp_path / "t.txt")
    assert [vars(p) for p in loaded] == [vars(p) for p in jtrials.load_evaluation_pairs(tmp_path / "t.txt")]
    (tmp_path / "bad.txt").write_text("1 id00000/a.wav id00001/b.wav\n")
    for load in (ttrials.load_evaluation_pairs, jtrials.load_evaluation_pairs):
        with pytest.raises(ValueError, match="read gt"):
            load(tmp_path / "bad.txt")


@pytest.mark.parametrize("case", ["random", "ties", "separable", "inverted", "small"])
def test_eer_and_mindcf_match_jax_exactly(case):
    rng = np.random.default_rng(3)
    gt = rng.integers(0, 2, 400)
    scores = {
        "random": rng.random(400),
        "ties": np.round(rng.random(400) * 10) / 10,
        "separable": gt + 0.1 * rng.random(400),
        "inverted": 1 - gt + 0.1 * rng.random(400),
        "small": rng.random(400),
    }[case]
    if case == "small":
        gt, scores = gt[:5], scores[:5]
    for fn in ("calculate_eer", "calculate_mdc"):
        assert getattr(tmetrics, fn)(gt, scores) == getattr(jmetrics, fn)(gt, scores), fn
    for drop in (False, True):
        for got, want in zip(tmetrics.roc_points(gt, scores, drop_intermediate=drop),
                             jmetrics.roc_points(gt, scores, drop_intermediate=drop)):
            np.testing.assert_array_equal(got, want)


def test_metric_errors_match_jax():
    for gt, scores in (([0, 1], [0.5]), ([], []), ([0, 2], [0.1, 0.2]), ([0, 1], [np.nan, 0.1])):
        with pytest.raises(ValueError) as got:
            tmetrics.calculate_eer(gt, scores)
        with pytest.raises(ValueError) as want:
            jmetrics.calculate_eer(gt, scores)
        assert str(got.value) == str(want.value)
    with pytest.raises(ZeroDivisionError):
        tmetrics.calculate_mdc([1, 1], [0.1, 0.2])


def _pairs(module, x, ids, n=60, seed=5):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(ids), (n, 2))
    return [(module.EmbeddingSample(ids[i], x[i]), module.EmbeddingSample(ids[j], x[j])) for i, j in idx]


def _make(module, backends, name, **kw):
    return {
        "cosine": lambda: module.CosineDistanceEvaluator(**kw),
        "asnorm": lambda: module.ASNormCosineEvaluator(**kw),
        "lda": lambda: backends.LDAEvaluator(**kw),
        "plda": lambda: backends.PLDAEvaluator(**kw),
    }[name]()


CASES = {
    "cosine_plain": ("cosine", {}, False),
    "cosine_center": ("cosine", {"center_before_scoring": True}, False),
    "cosine_center_norm": ("cosine", {"center_before_scoring": True, "length_norm_before_scoring": True}, False),
    "cosine_norm": ("cosine", {"length_norm_before_scoring": True}, False),
    "asnorm_labels": ("asnorm", {"cohort_topk": 5}, True),
    "asnorm_no_labels": ("asnorm", {"cohort_topk": 300}, False),
    "asnorm_center": ("asnorm", {"cohort_topk": 8, "center_before_scoring": True}, True),
    "lda": ("lda", {"num_pca_components": 10}, False),
    "plda": ("plda", {"num_pca_components": 8, "num_em_iterations": 4}, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluators_match_jax(case):
    name, kw, with_labels = CASES[case]
    x, labels, ids = _embeddings()
    train, _, _ = _embeddings(seed=9)
    got_e, want_e = _make(teval, tbackends, name, **kw), _make(jeval, jbackends, name, **kw)
    lab = labels if with_labels else None
    got_e.fit_parameters(list(train), lab)
    want_e.fit_parameters(list(train), lab)
    got = np.asarray(got_e._compute_prediction_scores(_pairs(teval, x, ids)))
    want = np.asarray(want_e._compute_prediction_scores(_pairs(jeval, x, ids)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    by_spk, n, seed = _trial_pairs(ids)
    trials = ttrials.generate_validation_pairs(by_spk, n, seed)
    got_m = got_e.evaluate(trials, [teval.EmbeddingSample(i, e) for i, e in zip(ids, x)])
    want_m = want_e.evaluate(
        [jtrials.EvaluationPair(p.same_speaker, p.sample1_id, p.sample2_id) for p in trials],
        [jeval.EmbeddingSample(i, e) for i, e in zip(ids, x)])
    assert got_m.keys() == want_m.keys()
    for key in got_m:
        np.testing.assert_allclose(got_m[key], want_m[key], rtol=RTOL, atol=ATOL, err_msg=key)
    assert 0 <= got_m["eer"] <= 1 and 0 <= got_m["mdc"] <= 1


@pytest.mark.parametrize("evaluator", EVALUATORS)
def test_build_evaluator_matches_jax_for_every_config(evaluator):
    cfg = {"evaluator": yaml.safe_load((ROOT / "config" / "evaluator" / f"{evaluator}.yaml").read_text())}
    got, want = texp.build_evaluator(cfg), jexp.build_evaluator(cfg)
    assert type(got).__name__ == type(want).__name__
    assert vars(got) == vars(want)
    x, labels, ids = _embeddings()
    got.fit_parameters(list(x), labels)
    want.fit_parameters(list(x), labels)
    np.testing.assert_allclose(got._compute_prediction_scores(_pairs(teval, x, ids)),
                               want._compute_prediction_scores(_pairs(jeval, x, ids)), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown evaluator"):
        texp.build_evaluator({"evaluator": {"name": "svm"}})


def test_evaluate_sentinels_and_unported_embeddings_match():
    x, _, ids = _embeddings()
    samples = [teval.EmbeddingSample(i, e) for i, e in zip(ids, x)]
    e = teval.CosineDistanceEvaluator()
    with pytest.warns(UserWarning, match="not in sample_map"):
        assert e.evaluate([ttrials.EvaluationPair(True, "nope", ids[0])], samples) == {
            "eer": -1, "eer_threshold": -1, "mdc": -1, "mdc_threshold": -1}
    with pytest.raises(ValueError, match="duplicate key"):
        e.evaluate([], samples + samples[:1])
    # layer ensembles and [T, D] frame embeddings, unported until the
    # ensemble slice: now scored as the JAX package scores them
    for embedding in ([x[0], x[1]], np.stack([x[0], x[1]])):
        for other in ([x[2], x[3]], np.stack([x[2], x[3], x[4]])):
            if isinstance(embedding, list) != isinstance(other, list):
                continue
            got = e._compute_prediction_scores([(teval.EmbeddingSample("a", embedding),
                                                 teval.EmbeddingSample("b", other))])
            want = jeval.CosineDistanceEvaluator()._compute_prediction_scores(
                [(jeval.EmbeddingSample("a", embedding), jeval.EmbeddingSample("b", other))])
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="fitted cohort"):
        teval.ASNormCosineEvaluator()._compute_prediction_scores(_pairs(teval, x, ids, n=2))
