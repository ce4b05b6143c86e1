"""The triplet recipes of the port against the JAX package, float32 on the
CPU at tiny widths: the triplet losses on the same mined indices, the
miner on its own, ``TripletBatchProcessor``'s batches, a ``triplet_ce``
training step, the loss config the recipes read, both packages'
``run.main`` on ``speaker_wav2vec2_triplet_ce``, and both packages'
``predict.main`` on a triplet-trained checkpoint (score files 1e-5).

The two packages mine from different generators (``jax.random.gumbel``
against a ``torch.Generator``), so their picks are not equal draw for draw.
Where a test compares them it hands both the same indices: fixed ones
(``_inject``), or in the run the first valid candidate of each anchor.

Limits: the losses rel 1e-6 (float32, one reduction); their gradients
5e-4 / 5e-5 (rtol / atol, the other step tests'); the step's loss rel 1e-5
and gradients 5e-4 / 5e-5; the miner's picks always valid and, over 4 000
draws, a chi-square statistic below its 1e-4 quantile (a miner that never
picks one candidate, or prefers the lowest index, reads far above it); the
batches exact; the run's losses 1e-5, the EERs exact and their thresholds
1e-5, as ``test_torch_run.py``'s. A positive index shifted by one row
(``test_a_shifted_positive_index_breaks_the_loss_limit``) reads far above
the loss limit."""

import contextlib
import functools
import importlib.util
import io
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2
from test_torch_run import Recorder, one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from test_torch_run_paired import write_corpus

from w2v2_speaker_tpu.data import batching as jbatching
from w2v2_speaker_tpu.data import samples as jsamples
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu.objectives import losses as jlosses
from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu.train import speaker_task as jtask
from w2v2_speaker_tpu_torch import run as trun
from w2v2_speaker_tpu_torch.data import batching as tbatching
from w2v2_speaker_tpu_torch.data import samples as tsamples
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_speaker as ts
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.objectives import losses as tlosses
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.train import speaker_task as ttask
from w2v2_speaker_tpu_torch.train import state as tstate
from w2v2_speaker_tpu_torch.train import steps as tsteps

ROOT = pathlib.Path(__file__).resolve().parents[1]
SR = 16000
TINY = dict(  # every rate at 0
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32,
    num_layers=2, num_heads=4, intermediate_size=64, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, layerdrop=0.0, mask_time_prob=0.0,
    hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 5e-4, 5e-5
STEP_RTOL = 1e-5
RUN_LOSS_ATOL = 1e-5
CHI2_P = 1e-4
LABELS = np.array([0, 0, 1, 1, 2, 2, 0, 1, 2, 0, 3, 4])  # labels 3 and 4 have no positive


def _indices(labels, seed):
    """A random valid (positive, negative) pick per anchor, 0 where there
    is none."""
    rng = np.random.default_rng(seed)
    pos, neg = np.zeros(len(labels), np.int64), np.zeros(len(labels), np.int64)
    for i, lab in enumerate(labels):
        p = [j for j in range(len(labels)) if labels[j] == lab and j != i]
        n = [j for j in range(len(labels)) if labels[j] != lab]
        pos[i] = rng.choice(p) if p else 0
        neg[i] = rng.choice(n) if n else 0
    return pos, neg


def _inject(monkeypatch, pos, neg):
    """Both packages' miners return ``pos``, ``neg``."""
    monkeypatch.setattr(jlosses, "mine_triplets", lambda rng, labels: (jnp.asarray(pos), jnp.asarray(neg)))
    monkeypatch.setattr(tlosses, "mine_triplets",
                        lambda labels, generator=None: (torch.as_tensor(pos), torch.as_tensor(neg)))


def _loss_pair(kind, emb, logits, labels):
    """(JAX value and grads, port value and grads) of ``kind``'s loss at
    margin 0.7 (c_ce 0.3, c_triplet 1.7 for ``triplet_ce``)."""
    if kind == "triplet":
        jf = lambda e, lg: jlosses.triplet_loss(e, jnp.asarray(labels), jax.random.PRNGKey(0), 0.7)  # noqa: E731
        tf = lambda e, lg: tlosses.triplet_loss(e, torch.as_tensor(labels), None, 0.7)  # noqa: E731
    else:
        jf = lambda e, lg: jlosses.triplet_cross_entropy(  # noqa: E731
            e, lg, jnp.asarray(labels), jax.random.PRNGKey(0), 0.3, 1.7, 0.7)[0]
        tf = lambda e, lg: tlosses.triplet_cross_entropy(  # noqa: E731
            e, lg, torch.as_tensor(labels), None, 0.3, 1.7, 0.7)[0]
    want, want_g = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(logits))
    e, lg = torch.tensor(emb, requires_grad=True), torch.tensor(logits, requires_grad=True)
    got = tf(e, lg)
    got_g = torch.autograd.grad(got, (e, lg), allow_unused=True)
    got_g = [np.zeros_like(logits) if g is None else g.numpy() for g in got_g]
    return (float(want), [np.asarray(g) for g in want_g]), (float(got.detach()), got_g)


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(len(LABELS), 6)).astype(np.float32),
            rng.normal(size=(len(LABELS), 5)).astype(np.float32))


@pytest.mark.parametrize("kind", ["triplet", "triplet_ce"])
@pytest.mark.parametrize("seed", [0, 1])
def test_triplet_losses_match_jax_on_the_same_indices(monkeypatch, kind, seed):
    """Values and gradients (embeddings, logits) on one set of valid
    indices; anchors of labels 3 and 4 (no positive) left out of both."""
    emb, logits = _loss_inputs(seed)
    _inject(monkeypatch, *_indices(LABELS, seed))
    (want, want_g), (got, got_g) = _loss_pair(kind, emb, logits, LABELS)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_a_shifted_positive_index_breaks_the_loss_limit(monkeypatch):
    """The planted fault: one anchor's positive moved by one row in the
    port alone. The triplet loss moves far beyond ``LOSS_RTOL``."""
    emb, logits = _loss_inputs(0)
    pos, neg = _indices(LABELS, 0)
    _inject(monkeypatch, pos, neg)
    (want, _), _ = _loss_pair("triplet", emb, logits, LABELS)
    shifted = pos.copy()
    shifted[0] = (shifted[0] + 1) % len(LABELS)
    monkeypatch.setattr(tlosses, "mine_triplets",
                        lambda labels, generator=None: (torch.as_tensor(shifted), torch.as_tensor(neg)))
    got = float(tlosses.triplet_loss(torch.from_numpy(emb), torch.as_tensor(LABELS), None, 0.7))
    assert abs(got - want) / want > 1e3 * LOSS_RTOL


def test_invalid_anchors_leave_the_mean():
    """An anchor without a positive (labels 3 and 4) is out of the mean:
    the loss equals the mean over the others, whatever its picks."""
    emb, _ = _loss_inputs(2)
    labels = torch.as_tensor(LABELS)
    gen = torch.Generator().manual_seed(5)
    pos, neg = tlosses.mine_triplets(labels, torch.Generator().manual_seed(5))
    got = tlosses.triplet_loss(torch.from_numpy(emb), labels, gen, 1.0)
    e = torch.from_numpy(emb)
    d = lambda a, b: ((a - b + 1e-6) ** 2).sum(-1).sqrt()  # noqa: E731
    per = (d(e, e[pos]) - d(e, e[neg]) + 1.0).clamp_min(0)
    torch.testing.assert_close(got, per[:10].mean(), rtol=1e-6, atol=0)


def test_miner_picks_are_valid_and_uniform():
    """4 000 draws over 8 anchors in two groups of 4: every positive shares
    the anchor's label and is another row, every negative has the other
    label; each anchor's picks spread evenly over its 3 positives and its
    4 negatives (chi-square below its ``CHI2_P`` quantile); the same seed
    gives the same picks."""
    labels = torch.as_tensor([0, 0, 0, 0, 1, 1, 1, 1])
    gen = torch.Generator().manual_seed(0)
    draws = [tlosses.mine_triplets(labels, gen) for _ in range(4000)]
    pos = torch.stack([p for p, _ in draws])  # [draws, 8]
    neg = torch.stack([n for _, n in draws])
    same = labels[pos] == labels[None, :]
    assert same.all() and (pos != torch.arange(8)).all() and (labels[neg] != labels[None, :]).all()
    for picks, cells in ((pos, 3), (neg, 4)):
        counts = np.stack([np.bincount(picks[:, i].numpy(), minlength=8) for i in range(8)])
        counts = counts[counts > 0].reshape(8, cells)
        expected = len(draws) / cells
        stat = float(((counts - expected) ** 2 / expected).sum())
        assert stat < chi2.ppf(1 - CHI2_P, 8 * (cells - 1)), (cells, stat)
    again = tlosses.mine_triplets(labels, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(again, draws[0]))


def _samples(module, n_speakers=9, per_speaker=(2, 7), seed=0):
    """Speaker samples in runs of 4 per speaker (as shards write them),
    speakers with 2-7 utterances each, for one package's sample class."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(*per_speaker, n_speakers)
    queue = [[(s, u) for u in range(c)] for s, c in enumerate(counts)]
    out = []
    while any(queue):
        for s in range(n_speakers):
            run, queue[s] = queue[s][:4], queue[s][4:]
            out.extend(module.SpeakerSample(key=f"id{s}/{u}", wav=np.full(8, s + u / 10, np.float32),
                                            ground_truth=s) for s, u in run)
    return out


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("batch_size, queue", [(8, 12), (6, 30)])
def test_triplet_batches_match_jax(seed, batch_size, queue):
    """The same batches (keys, labels, waveforms) in the same order from the
    same samples and seed; every batch holds >= 2 speakers with >= 2
    samples each."""
    def batches(batching, samples):
        proc = batching.TripletBatchProcessor(batch_size, queue, samples.collate_speaker_batch, seed=seed)
        return list(proc(_samples(samples, seed=seed)))

    got, want = batches(tbatching, tsamples), batches(jbatching, jsamples)
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g["keys"] == w["keys"]
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["features"], w["features"])
    for b in got:
        _, counts = np.unique(b["labels"], return_counts=True)
        assert len(b["keys"]) == batch_size and len(counts) >= 2 and counts.min() >= 2


def test_triplet_batch_processor_errors():
    with pytest.raises(ValueError, match="batch size needs to be even"):
        tbatching.TripletBatchProcessor(7, 16, tsamples.collate_speaker_batch)
    lonely = [tsamples.SpeakerSample(key=f"k{i}", wav=np.zeros(4, np.float32), ground_truth=i) for i in range(20)]
    with pytest.raises(ValueError, match="queue exceeded limit while unable to ensure triplets"):
        list(tbatching.TripletBatchProcessor(4, 8, tsamples.collate_speaker_batch)(lonely))
    twice = lonely[:2] + lonely[:1]
    with pytest.raises(ValueError, match="duplicate sample"):
        list(tbatching.TripletBatchProcessor(4, 8, tsamples.collate_speaker_batch)(twice))


@functools.lru_cache(maxsize=None)
def _jax_model():
    model = js.Wav2Vec2SpeakerModel(cfg=js.Wav2Vec2SpeakerConfig(w2v2=jw.Wav2Vec2Config(**TINY)), num_speakers=6)
    z = jnp.zeros((2, 1600))
    return model, jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), z, jnp.ones((2, 1600), bool))["params"])


@pytest.mark.parametrize("mode", ["triplet", "triplet_ce"])
def test_triplet_train_step_matches_jax(monkeypatch, mode):
    """One step from the same weights on the same mined indices: the JAX
    task's loss and gradients against the port's ``make_train_step``."""
    jmodel, params = _jax_model()
    cfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY))
    tmodel = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=6)
    tmodel.load_state_dict(params_from_jax(params, cfg), strict=True)
    rng = np.random.default_rng(4)
    lengths = np.array([1600, 1310, 1020, 700, 1600, 1500])
    mask = np.arange(1600)[None, :] < lengths[:, None]
    labels = np.array([0, 0, 3, 3, 5, 0], np.int32)
    batch = {"features": rng.normal(0, 0.5, (6, 1600)).astype(np.float32) * mask, "mask": mask, "labels": labels}
    _inject(monkeypatch, *_indices(labels, 4))
    jt = jtask.SpeakerTask(model=jmodel, mode=mode, triplet_margin=0.5, c_ce=0.5, c_triplet=2.0)
    want, want_grads = jax.jit(jax.value_and_grad(lambda p: jt.loss_fn(
        p, {}, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(2), train=True)[0]))(params)
    tt = ttask.SpeakerTask(tmodel, mode, triplet_margin=0.5, c_ce=0.5, c_triplet=2.0)
    state = tstate.TrainState.create(tmodel, tstate.AdamTx(lambda step: 1e-3), seed=0)
    _, metrics = tsteps.make_train_step(tt)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(want)) and float(want) > 0
    np.testing.assert_allclose(metrics["loss"].item(), float(want), rtol=STEP_RTOL)
    assert ("accuracy" in metrics) == (mode == "triplet_ce")
    for name, g in params_from_jax(jax.device_get(want_grads), cfg).items():
        np.testing.assert_allclose(dict(tmodel.named_parameters())[name].grad.numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("recipe", ["speaker_wav2vec2_triplet", "speaker_wav2vec2_triplet_ce"])
def test_triplet_loss_config_is_read_where_the_jax_package_drops_it(recipe):
    """At the shipped values both packages build the task's defaults (1.0);
    with ``optim.loss.margin=0.5`` (and ``c_ce``, ``c_triplet``) the port
    uses the override and the JAX package keeps 1.0 (ROADMAP Queue 3)."""
    loss = recipe.removeprefix("speaker_wav2vec2_")
    for overrides, want in (([], (1.0, 1.0, 1.0)),
                            (["optim.loss.margin=0.5", "+optim.loss.c_ce=0.25", "+optim.loss.c_triplet=3.0"],
                             (0.5, 0.25, 3.0))):
        if loss == "triplet_ce" and overrides:
            overrides = ["optim.loss.margin=0.5", "optim.loss.c_ce=0.25", "optim.loss.c_triplet=3.0"]
        cfg = texp.load_recipe(recipe, ["network.wav2vec2_size=tiny", *overrides])
        with torch.device("meta"):
            task, kind = texp.build_model_and_task(cfg, 5)
        jtask_, jkind = jexp.build_model_and_task(cfg, 5)
        assert kind == jkind == "speaker" and task.mode == jtask_.mode == loss
        assert (task.triplet_margin, task.c_ce, task.c_triplet) == want
        assert (jtask_.triplet_margin, jtask_.c_ce, jtask_.c_triplet) == (1.0, 1.0, 1.0)


# ------------------------------------------------------------------ the run


def _deterministic_miners(monkeypatch):
    """Both packages mine the first valid positive and negative of each
    anchor, so that their runs train on the same triplets."""
    def jax_mine(rng, labels):
        same = labels[:, None] == labels[None, :]
        eye = jnp.eye(labels.shape[0], dtype=bool)
        return jnp.argmax(same & ~eye, axis=1), jnp.argmax(~same, axis=1)

    def torch_mine(labels, generator=None):
        same = labels[:, None] == labels[None, :]
        eye = torch.eye(labels.shape[0], dtype=torch.bool)
        return (same & ~eye).int().argmax(dim=1), (~same).int().argmax(dim=1)

    monkeypatch.setattr(jlosses, "mine_triplets", jax_mine)
    monkeypatch.setattr(tlosses, "mine_triplets", torch_mine)


def _overrides(corpus, out: pathlib.Path, *extra):
    wav_dir, trials = corpus
    return [
        "+experiment=speaker_wav2vec2_triplet_ce", "network.wav2vec2_size=tiny", "network.layerdrop=0.0",
        "network.hidden_dropout=0.0", "network.attention_dropout=0.0", "network.feat_proj_dropout=0.0",
        "network.mask_time_prob=0.0", "trainer.precision=f32", f"data.module.data_dir={wav_dir}",
        f"data.module.shards_dir={out / 'shards'}", f"data.module.test_trial_path={trials}",
        "data.module.train_val_ratio=0.7", "data.module.eer_validation_pairs=10",
        "data.shards.samples_per_shard=8", "data.dataloader.batch_size=8", "data.dataloader.test_batch_size=4",
        "data.dataloader.test_pad_to_multiple=4800", "data.pipeline.chunk_length_sec=0.15",
        "trainer.max_steps=4", "trainer.val_check_interval=2", "trainer.steps_per_dispatch=2",
        "trainer.num_sanity_val_steps=0", "trainer.log_every=1", "trainer.log_dir=null",
        f"trainer.checkpoint_dir={out / 'ckpt'}", "seed=6", *extra,
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``speaker_wav2vec2_triplet_ce`` runs from the same
    weights with the first-valid miner: the recorded steps and
    evaluations, each step's batch labels, the objectives."""
    import run as jrun
    from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config
    from w2v2_speaker_tpu.train.checkpoint import save_params

    tmp = tmp_path_factory.mktemp("torch_triplet_run")
    corpus = write_corpus(tmp)
    task, _ = jexp.build_model_and_task(jax_load_config(ROOT / "config", "train_eval", _overrides(corpus, tmp)), 5)
    params, _ = task.init(jax.random.PRNGKey(7), {"features": jnp.zeros((2, SR // 10))})
    save_params(tmp / "init", params)
    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    export.main([str(tmp / "init"), str(tmp / "init.npz")])

    monkeypatch = pytest.MonkeyPatch()
    rec = Recorder(monkeypatch)
    _deterministic_miners(monkeypatch)
    labels = {"jax": [], "torch": []}
    for name, mod in (("jax", jbatching), ("torch", tbatching)):
        def draw(self_, by_speaker, name=name, orig=mod.TripletBatchProcessor._draw):
            batch = orig(self_, by_speaker)
            labels[name].append(np.asarray(batch["labels"]).tolist())
            return batch
        monkeypatch.setattr(mod.TripletBatchProcessor, "_draw", draw)
    objectives = {}
    try:
        for name, init in (("jax", tmp / "init"), ("torch", tmp / "init.npz")):
            argv = _overrides(corpus, tmp / name, f"load_network_from_checkpoint={init}")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                objectives[name] = jrun.main(argv) if name == "jax" else trun.main(argv, device="cpu")
            sys.stdout.write(out.getvalue())
    finally:
        monkeypatch.undo()
    return rec, labels, objectives


def test_triplet_run_matches_jax_run(runs):
    """Steps 1-4 in dispatches of 2 on the same triplet batches: the same
    losses, validation and test EERs, and objective."""
    rec, labels, objectives = runs
    assert labels["torch"] == labels["jax"] and len(labels["torch"]) >= 4
    for batch in labels["torch"]:
        _, counts = np.unique(batch, return_counts=True)
        assert len(counts) >= 2 and counts.min() >= 2
    assert [s for s, _ in rec.steps["torch"]] == [s for s, _ in rec.steps["jax"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in rec.steps["torch"]], [v for _, v in rec.steps["jax"]],
                               rtol=0, atol=RUN_LOSS_ATOL)
    assert len(rec.evals["torch"]) == len(rec.evals["jax"]) == 3
    for (gs, got), (ws, want) in zip(rec.evals["torch"], rec.evals["jax"]):
        assert gs == ws and sorted(got) == sorted(want)
        for k, v in got.items():
            assert v == pytest.approx(want[k], rel=0, abs=1e-5 if k.endswith("threshold") else 0), k
    assert objectives["torch"] == objectives["jax"] and 0 <= objectives["torch"] <= 1


def test_predict_serves_a_triplet_checkpoint_as_jax(tmp_path_factory):
    """A ``wav2vec2_fc`` model trained with ``optim/loss=triplet_ce`` is
    served by the predict twin (it raised before the triplet modes were
    ported) with the JAX package's ``predict.main``'s scores, to 1e-5."""
    import predict as jax_predict
    from test_torch_predict import SCORE_ATOL, _scores, _write_folder

    from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config
    from w2v2_speaker_tpu.train.checkpoint import save_params
    from w2v2_speaker_tpu_torch import predict as torch_predict

    overrides = ["network=wav2vec2_fc", "optim/loss=triplet_ce", "network.wav2vec2_size=tiny", "trainer.precision=f32",
                 "data.dataloader.test_pad_to_multiple=8000", "data.dataloader.test_batch_size=4"]
    tmp = tmp_path_factory.mktemp("triplet_ckpt")
    task, _ = jexp.build_model_and_task(jax_load_config(ROOT / "config", "predict", overrides), 2)
    params, _ = task.init(jax.random.PRNGKey(7), {"features": jnp.zeros((2, 16000))})
    save_params(tmp / "init", params)
    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    export.main([str(tmp / "init"), str(tmp / "init.npz")])
    runs = {}
    for name, ckpt in (("jax", tmp / "init"), ("torch", tmp / "init.npz")):
        folder = tmp_path_factory.mktemp(name)
        argv = [*overrides, f"predict_folder_path={folder}", f"pair_prediction_path={_write_folder(folder)}",
                f"load_network_from_checkpoint={ckpt}"]
        runs[name] = _scores(jax_predict.main(argv) if name == "jax" else torch_predict.main(argv, device="cpu"))
    (want, want_pairs), (got, got_pairs) = runs["jax"], runs["torch"]
    assert got_pairs == want_pairs and len(got) == 10
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
