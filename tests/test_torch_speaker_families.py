"""The networks off the wav2vec2 backbone against the JAX package's on the
CPU: x-vector and ECAPA-TDNN behind the fbank frontend, wav2spk and the
dummy model, at small widths (x-vector TDNN 16 x 4 + 32; ECAPA channels
32 x 4 + 96, Res2Net scale 4, SE 8, attention 16, 16-d; wav2spk at its
module widths on ~1 s of audio), from the same weights carried across by
``params_from_jax`` (and random running statistics for the eval forward).
Also ECAPA's attentive pooling options, ``multi_step_decay``, the
recipes' configs against the JAX package's ``build_model_and_task``, its
``ValueError``s, ``network.pretrained_checkpoint`` on these networks (the
JAX package raises, the port keeps the initialisation), the initial
draws of the temporal gate, and the 14 recipes of ``config/experiment/``
built in the port.

Limits, each between the as-built reading and a planted fault's (the
``*_catches_*`` tests read the faults):

- eval embeddings and logits, max abs error over max abs (float32, the
  same math in other summation orders): 1e-4 (read 1.8e-6 at most); a
  transposed ``TemporalGate.W`` reads 0.135 on wav2spk's embedding;
- one training step on a padded batch: the loss 5e-4 relative, every
  gradient 3e-2 of its tensor's max abs, every updated running statistic
  5e-4 of its max abs. As built they read 6.5e-5, 5.8e-3 and 4.6e-6 at
  most: ECAPA loses the most digits in its training BatchNorms, whose
  variance E[x^2] - E[x]^2 (flax's, kept) cancels on the 3 rows that
  ``asp_bn`` normalises. A BatchNorm with the unbiased variance reads
  0.22 (ECAPA) and 0.26 (x-vector) on the gradients and 8.1e-3 on ECAPA's
  running statistics; ECAPA masking before its 1x1 blocks too reads 0.74
  on the running statistics and 2.6 on the gradients.
"""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.data.features import FbankConfig as JaxFbankConfig
from w2v2_speaker_tpu.models import dummy as jdummy
from w2v2_speaker_tpu.models import ecapa as jecapa
from w2v2_speaker_tpu.models import pooling as jpooling
from w2v2_speaker_tpu.models import temporal_gate as jgate
from w2v2_speaker_tpu.models import wav2spk as jwav2spk
from w2v2_speaker_tpu.models import xvector as jxv
from w2v2_speaker_tpu.models.frontend import FbankFrontend as JaxFrontend
from w2v2_speaker_tpu.objectives import schedules as jsched
from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu.train.speaker_task import SpeakerTask as JaxSpeakerTask
from w2v2_speaker_tpu_torch.data.features import FbankConfig
from w2v2_speaker_tpu_torch.data.tokenizer import CharTokenizer
from w2v2_speaker_tpu_torch.models import dummy as tdummy
from w2v2_speaker_tpu_torch.models import ecapa as tecapa
from w2v2_speaker_tpu_torch.models import pooling as tpool
from w2v2_speaker_tpu_torch.models import temporal_gate as tgate
from w2v2_speaker_tpu_torch.models import wav2spk as twav2spk
from w2v2_speaker_tpu_torch.models import xvector as txv
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.models.frontend import FbankFrontend
from w2v2_speaker_tpu_torch.models.wav2vec2 import init_parameters
from w2v2_speaker_tpu_torch.objectives import schedules as tsched
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.train.speaker_task import SpeakerTask

EVAL_RTOL = 1e-4
STEP_LIMITS = {"loss": 5e-4, "grads": 3e-2, "stats": 5e-4}
GRAD_FLOOR = 1e-3
SPEAKERS = 5
LENGTHS = (16000, 12000, 7000)
XV = dict(tdnn_channels=(16, 16, 16, 16, 32), lin_neurons=16)
EC = dict(channels=(32, 32, 32, 32, 96), res2net_scale=4, se_channels=8, attention_channels=16, lin_neurons=16)
WS = dict(hidden_fc_layers_out=(32,), embedding_layer_idx=0)
MODELS = ("xvector", "ecapa_aam", "ecapa_ce", "wav2spk_mean", "wav2spk_mean+std", "wav2spk_nogate", "dummy")
EXPERIMENTS = sorted(p.stem for p in (pathlib.Path(__file__).resolve().parents[1] / "config" / "experiment")
                     .glob("*.yaml"))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    n = max(LENGTHS)
    t = np.arange(n) / 16000
    wav = rng.normal(0, 0.3, (len(LENGTHS), n)) + np.sin(2 * np.pi * rng.uniform(100, 3000, (len(LENGTHS), 1)) * t)
    mask = np.arange(n)[None, :] < np.asarray(LENGTHS)[:, None]
    return (wav * mask).astype(np.float32), mask, np.array([1, 4, 1], dtype=np.int32)


def _fields(cfg, cls):
    return cls(**{k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"})


def build(name):
    """(JAX model, port model, mode) of ``name`` at the test widths."""
    if name == "xvector":
        cfg = jxv.XVectorConfig(in_channels=40, **XV)
        return (JaxFrontend(jxv.XVectorModel(cfg, SPEAKERS), fbank=JaxFbankConfig(n_mels=40)),
                FbankFrontend(txv.XVectorModel(_fields(cfg, txv.XVectorConfig), SPEAKERS), FbankConfig(n_mels=40)),
                "ce")
    if name.startswith("ecapa"):
        cfg, aam = jecapa.EcapaConfig(**EC), name == "ecapa_aam"
        return (JaxFrontend(jecapa.EcapaModel(cfg, SPEAKERS, use_aam=aam), fbank=JaxFbankConfig(n_mels=80)),
                FbankFrontend(tecapa.EcapaModel(_fields(cfg, tecapa.EcapaConfig), SPEAKERS, use_aam=aam),
                              FbankConfig(n_mels=80)),
                "aam" if aam else "ce")
    if name.startswith("wav2spk"):
        pooling = "mean" if name == "wav2spk_nogate" else name.split("_")[1]
        cfg = jwav2spk.Wav2SpkConfig(apply_temporal_gating=name != "wav2spk_nogate", stat_pooling_type=pooling, **WS)
        return (jwav2spk.Wav2SpkModel(cfg, SPEAKERS),
                twav2spk.Wav2SpkModel(_fields(cfg, twav2spk.Wav2SpkConfig), SPEAKERS), "ce")
    return jdummy.DummyModel(SPEAKERS), tdummy.DummyModel(SPEAKERS), "ce"


def _random_stats(tree, rng):
    """``batch_stats`` of the same structure with random means and
    variances, so that eval normalises with something other than 0 / 1."""
    return {k: _random_stats(v, rng) if isinstance(v, dict) else
            (rng.normal(0, 0.2, v.shape) if k == "mean" else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def jax_side(name):
    """The JAX model's weights (random running statistics for eval), its
    eval outputs on batch 1 and one training step's loss, gradients and
    running statistics on batch 2; jitted, computed once per process."""
    jmodel, _, mode = build(name)
    wav, mask, _ = _batch()
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(mask)))
    params, stats = v["params"], v.get("batch_stats", {})
    eval_stats = _random_stats(stats, np.random.default_rng(0))
    wav, mask, _ = _batch(1)
    outputs = jax.device_get(jax.jit(jmodel.apply)({"params": params, "batch_stats": eval_stats},
                                                   jnp.asarray(wav), jnp.asarray(mask)))
    wav, mask, labels = _batch(2)
    batch = {"features": jnp.asarray(wav), "mask": jnp.asarray(mask), "labels": jnp.asarray(labels)}
    task = JaxSpeakerTask(model=jmodel, mode=mode)
    model_state = {"batch_stats": stats} if stats else {}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: task.loss_fn(p, model_state, batch, jax.random.PRNGKey(0), train=True), has_aux=True))(params)
    stepped = params_from_jax(jax.device_get(grads), None, jax.device_get(aux["model_state"]).get("batch_stats"))
    return params, stats, eval_stats, outputs, float(loss), stepped


def port_model(name, stats_key="stats"):
    """The port's model of ``name`` holding the JAX weights, with the
    initial (``stats``) or the random (``eval_stats``) running statistics."""
    _, tmodel, mode = build(name)
    params, stats, eval_stats, *_ = jax_side(name)
    tmodel.load_state_dict(params_from_jax(params, None, eval_stats if stats_key == "eval_stats" else stats),
                           strict=True)
    return tmodel, mode


def _rel(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor, 1e-12))


def eval_errors(name, transpose_gate=False):
    """{output: max abs err / max abs} of the eval forward and
    ``compute_embedding`` on the padded batch."""
    tmodel, _ = port_model(name, "eval_stats")
    want = jax_side(name)[3]
    if transpose_gate:
        with torch.no_grad():
            tmodel.gate.W.copy_(tmodel.gate.W.T.clone())
    wav, mask, _ = _batch(1)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(wav), torch.from_numpy(mask))
        emb = tmodel.compute_embedding(torch.from_numpy(wav), torch.from_numpy(mask))
    assert (got["logits"] is None) == (want["logits"] is None)
    errors = {k: _rel(got[k], want[k]) for k in ("embedding", "logits") if want[k] is not None}
    errors["compute_embedding"] = _rel(emb, want["embedding"])
    return errors


def step_errors(name, batch_norm_forward=None, ecapa_forward=None):
    """One float32 training step on the padded batch from the same weights:
    {"loss": rel err, "grads": the worst gradient's max abs err over its
    max abs (floored at ``GRAD_FLOOR`` of the largest gradient, for the
    gradients that are 0 in exact arithmetic: a bias before a
    normalisation or a softmax over time), "stats": the worst updated
    running statistic's}. The two arguments plant a ``BatchNorm.forward``
    or an ``_TDNNBlock.forward`` into the port."""
    tmodel, mode = port_model(name)
    *_, jloss, want = jax_side(name)
    wav, mask, labels = _batch(2)
    patches = [(cls, attr, fn, getattr(cls, attr)) for cls, attr, fn in
               ((tpool.BatchNorm, "forward", batch_norm_forward), (tecapa._TDNNBlock, "forward", ecapa_forward))
               if fn is not None]
    try:
        for cls, attr, fn, _ in patches:
            setattr(cls, attr, fn)
        tbatch = {"features": torch.from_numpy(wav), "mask": torch.from_numpy(mask),
                  "labels": torch.from_numpy(labels).long()}
        loss, _ = SpeakerTask(tmodel, mode).loss_fn(tbatch, torch.Generator().manual_seed(0), train=True)
        loss.backward()
    finally:
        for cls, attr, _, orig in patches:
            setattr(cls, attr, orig)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    buffers = dict(tmodel.named_buffers())
    assert set(grads) | set(buffers) == set(want)
    floor = GRAD_FLOOR * max(float(want[n].abs().max()) for n in grads)
    return {"loss": _rel(float(loss.detach()), jloss),
            "grads": max(_rel(grads[n], want[n], floor) for n in grads),
            "stats": max([_rel(buffers[n], want[n]) for n in buffers], default=0.0)}


def unbiased_batch_norm(self, x, train=False):
    """``BatchNorm.forward`` with the unbiased variance (a planted fault)."""
    if not train:
        return REAL_BATCH_NORM(self, x, train)
    axis = self.axis % x.ndim
    axes = tuple(d for d in range(x.ndim) if d != axis)
    mean, var = x.mean(dim=axes), x.var(dim=axes, unbiased=True)
    with torch.no_grad():
        self.running_mean.mul_(0.9).add_(0.1 * mean)
        self.running_var.mul_(0.9).add_(0.1 * var)
    shape = [-1 if d == axis else 1 for d in range(x.ndim)]
    return (x - mean.view(shape)) * (torch.rsqrt(var + 1e-5) * self.weight).view(shape) + self.bias.view(shape)


def ecapa_masking_every_block(self, x, mask=None, train=False):
    """``_TDNNBlock.forward`` masking before 1x1 convs too (a planted fault)."""
    return txv.TDNNBlock.forward(self, x if mask is None else x * mask, train)


REAL_BATCH_NORM = tpool.BatchNorm.forward


@pytest.fixture(scope="module")
def readings():
    """Each model's eval and step errors, computed once."""
    return {name: (eval_errors(name), step_errors(name)) for name in MODELS}


@pytest.mark.parametrize("name", MODELS)
def test_eval_forward_matches_jax(readings, name):
    errors = readings[name][0]
    assert all(err <= EVAL_RTOL for err in errors.values()), errors


@pytest.mark.parametrize("name", MODELS)
def test_training_step_matches_jax(readings, name):
    """Loss, every gradient and the running statistics after one step
    (ECAPA under AAM and CE, the wav2spk poolings and without the gate)."""
    errors = readings[name][1]
    assert all(errors[k] <= limit for k, limit in STEP_LIMITS.items()), errors


def test_eval_limit_catches_a_transposed_gate():
    assert eval_errors("wav2spk_mean", transpose_gate=True)["embedding"] > 100 * EVAL_RTOL


@pytest.mark.parametrize("name, key", [("ecapa_aam", "stats"), ("ecapa_ce", "grads"), ("xvector", "grads")])
def test_step_limit_catches_an_unbiased_batch_norm(name, key):
    assert step_errors(name, batch_norm_forward=unbiased_batch_norm)[key] > 5 * STEP_LIMITS[key]


@pytest.mark.parametrize("key", ["stats", "grads"])
def test_step_limit_catches_ecapa_masking_its_1x1_blocks(key):
    assert step_errors("ecapa_ce", ecapa_forward=ecapa_masking_every_block)[key] > 10 * STEP_LIMITS[key]


def test_temporal_gate_matches_jax_and_fails_transposed():
    """``W`` is applied as ``[out, in]``: the JAX gate's parameters loaded
    as they are give its output; transposed (same shape) they do not."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 7, 12)).astype(np.float32)
    params = jax.device_get(jgate.TemporalGate(12).init(jax.random.PRNGKey(1), jnp.asarray(x)))["params"]
    want = np.asarray(jgate.TemporalGate(12).apply({"params": params}, jnp.asarray(x)))
    gate = tgate.TemporalGate(12)
    gate.load_state_dict(params_from_jax(params), strict=True)
    channels_first = torch.from_numpy(x).transpose(1, 2)
    assert _rel(gate(channels_first).transpose(1, 2).detach(), want) <= EVAL_RTOL
    gate.load_state_dict({"W": torch.from_numpy(np.asarray(params["W"]).T.copy()), "b": gate.b.detach()})
    assert _rel(gate(channels_first).transpose(1, 2).detach(), want) > 100 * EVAL_RTOL


def test_init_parameters_draws_the_gate_and_resets_batch_norms():
    model = twav2spk.Wav2SpkModel(twav2spk.Wav2SpkConfig(), SPEAKERS)
    init_parameters(model, torch.Generator().manual_seed(0))
    w, b = model.gate.W.detach(), model.gate.b.detach()
    std = (1.0 / 512) ** 0.5
    assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6 and abs(float(w.std()) - std) < 0.05 * std
    assert abs(float(b.std()) - (2.0 / 513) ** 0.5) < 0.2 * (2.0 / 513) ** 0.5
    ecapa = tecapa.EcapaModel(tecapa.EcapaConfig(**EC), SPEAKERS)
    for bn in [m for m in ecapa.modules() if isinstance(m, tpool.BatchNorm)]:
        bn.running_var.fill_(3.0)
    init_parameters(ecapa, torch.Generator().manual_seed(0))
    bns = [m for m in ecapa.modules() if isinstance(m, tpool.BatchNorm)]
    assert len(bns) == 1 + 3 * (2 + 3) + 1 + 2 and all(float(m.running_var.min()) == 1.0 for m in bns)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 39999, 40000, 40001, 69999, 70000, 70001])
def test_multi_step_decay_matches_jax(step):
    want = float(jsched.multi_step_decay(1e-3, [70000, 40000], 0.1)(step))
    got = tsched.multi_step_decay(1e-3, [70000, 40000], 0.1)(step)
    assert got == pytest.approx(want, rel=1e-6)
    small = tsched.multi_step_decay(1e-3, [2, 3], 0.1)
    assert [small(s) for s in range(5)] == pytest.approx([1e-3, 1e-3, 1e-4, 1e-5, 1e-5], rel=1e-12)


@pytest.mark.parametrize("recipe", ["speaker_xvector", "speaker_ecapa_tdnn", "speaker_wav2spk", "speaker_dummy"])
def test_recipe_models_match_jax_build_model_and_task(recipe):
    cfg = texp.load_recipe(recipe)
    want, want_kind = jexp.build_model_and_task(cfg, 1211)
    with torch.device("meta"):
        got, kind = texp.build_model_and_task(cfg, 1211)
    assert kind == want_kind == "speaker" and got.mode == want.mode
    jm, tm = want.model, got.model
    if isinstance(jm, JaxFrontend):
        assert dataclasses.asdict(tm.fbank) == dataclasses.asdict(jm.fbank)
        jm, tm = jm.inner, tm.inner
    assert type(tm).__name__ == type(jm).__name__
    if hasattr(jm, "cfg"):
        want_cfg = {k: v for k, v in dataclasses.asdict(jm.cfg).items() if k != "dtype"}
        assert dataclasses.asdict(tm.cfg) == want_cfg and jm.cfg.dtype == "float32"
    if recipe == "speaker_ecapa_tdnn":
        assert tm.use_aam and jm.use_aam and not hasattr(tm, "classifier")
        assert (tm.aam.margin, tm.aam.scale, tm.aam.weights.shape[0]) == (jm.aam_margin, jm.aam_scale, 1211)
    else:
        assert jm.num_speakers == 1211


@pytest.mark.parametrize("network", ["xvector", "wav2spk"])
def test_aam_raises_as_in_jax(network):
    cfg = texp.load_recipe("speaker_wav2vec2_aam", [f"network={network}"])
    with pytest.raises(ValueError, match=f"{network} does not support aam softmax"):
        jexp.build_model_and_task(cfg, 4)
    with pytest.raises(ValueError, match=f"{network} does not support aam softmax"):
        texp.build_model_and_task(cfg, 4)


def test_unknown_wav2spk_pooling_raises_as_in_jax():
    with pytest.raises(ValueError, match="wav2spk supports 'mean' and 'mean\\+std'"):
        twav2spk.Wav2SpkModel(twav2spk.Wav2SpkConfig(stat_pooling_type="max"))
    cfg = texp.load_recipe("speaker_wav2spk", ["network.stat_pooling_type=max"])
    with pytest.raises(ValueError, match="wav2spk supports"):
        jtask, _ = jexp.build_model_and_task(cfg, 4)
        jtask.model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16000)))


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_every_recipe_builds_in_the_port(experiment):
    """``load_recipe``, ``build_model_and_task`` (the speech and multitask
    recipes with a character vocabulary) and ``build_optimizer``."""
    cfg = texp.load_recipe(experiment)
    tokenizer = None
    if cfg["network"]["name"] in ("wav2vec2_fc_letter", "wav2vec2_multitask"):
        tokenizer = CharTokenizer.build(["abc def"])
    with torch.device("meta"):
        task, kind = texp.build_model_and_task(cfg, 7, tokenizer=tokenizer)
    assert kind in ("speaker", "paired", "speech", "multitask") and task.model is not None
    texp.build_optimizer(cfg)


@pytest.mark.parametrize("recipe", ["speaker_xvector", "speaker_dummy"])
def test_pretrained_checkpoint_leaves_a_network_off_the_backbone_at_init_where_jax_raises(recipe, capsys):
    """``network.pretrained_checkpoint`` names a wav2vec2 checkpoint. The
    JAX package's ``_init_state`` builds a wav2vec2 config from the network
    to read it and raises ``KeyError`` for these networks, which lack the
    wav2vec2 keys; the port leaves the model at its initialisation and says
    so (ROADMAP Queue 3)."""
    cfg = texp.load_recipe(recipe, ["+network.pretrained_checkpoint=missing.bin"])
    jtask, _ = jexp.build_model_and_task(cfg, 4)
    with pytest.raises(KeyError, match="activation_dropout"):
        jexp._init_state(cfg, jtask, {"features": jnp.zeros((2, 16000))})
    task, _ = texp.build_model_and_task(cfg, 4)
    init_parameters(task.model, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    texp.graft_pretrained(task.model, cfg["network"])
    assert "has no wav2vec2 submodule; the checkpoint is not loaded" in capsys.readouterr().out
    assert all(torch.equal(v, before[k]) for k, v in task.model.state_dict().items())


@pytest.mark.parametrize("global_context", [True, False], ids=["global", "local"])
def test_attentive_pool_options_match_jax(global_context):
    """ECAPA's ``asp`` with its config's attention width and context,
    in training (BatchNorm on batch statistics) and eval."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 9, 12)).astype(np.float32)
    mask = np.arange(9)[None, :] < np.array([9, 5, 2])[:, None]
    jpool = jpooling.AttentiveStatPool(attention_channels=16, global_context=global_context)
    v = jax.device_get(jpool.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask)))
    want, stats = jpool.apply(v, jnp.asarray(x), jnp.asarray(mask), train=True, mutable=["batch_stats"])
    pool = tpool.AttentiveStatPool(12, 16, global_context)
    pool.load_state_dict(params_from_jax(v["params"], None, v["batch_stats"]), strict=True)
    got = pool(torch.from_numpy(x), torch.from_numpy(mask), train=True).detach()
    assert _rel(got, want) <= EVAL_RTOL
    new = params_from_jax({}, None, jax.device_get(stats["batch_stats"]))
    assert all(_rel(getattr(pool.attn_bn, k.split(".")[-1]), w) <= EVAL_RTOL for k, w in new.items())
    eval_want = jpool.apply({"params": v["params"], **stats}, jnp.asarray(x), jnp.asarray(mask))
    assert _rel(pool(torch.from_numpy(x), torch.from_numpy(mask)).detach(), eval_want) <= EVAL_RTOL
