"""The TPU-era run knobs on the port (``trainer.remat`` /
``network.remat_policy``, ``trainer.deterministic``), on the CPU at tiny
geometry. ``profiler=simple`` and both knobs under the run twin are
``tests/test_torch_run.py``'s (on its corpus); on the card, ``chip_smoke.py``
phase 35.

Remat is held bit for bit: the step with each policy against the step
without remat from the same weights and generator seed, with every
dropout site, SpecAugment and layerdrop on, in both dropout routes (the
counter hash and the Bernoulli masks): loss, every gradient, the
generator's final state. The JAX package's ``nn.remat`` gives the same
numbers with and without (a recompute of the same program); so must the
port's, though its recompute must not draw from the step generator again.
"""

import functools
import os

import numpy as np
import pytest
import torch

from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_speaker as ts
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.train import speaker_task as ttask

TINY = dict(
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32, num_layers=4, num_heads=4,
    intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, layerdrop=0.3,
    mask_time_prob=0.3, mask_time_length=3, hidden_dropout=0.1, attention_dropout=0.1,
    feat_proj_dropout=0.1, activation_dropout=0.1,
)
LENGTHS = [1600, 1310, 1020, 700]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: at these shapes eight threads buy nothing alone
    and cost every worker of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _step(remat, policy, hash_dropout):
    """(loss, gradients by name, generator state after, layer forwards run)
    of one CE step of a regularised tiny speaker model."""
    cfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(
        **TINY, remat=remat, remat_policy=policy, hash_dropout=hash_dropout), stat_pooling_type="mean")
    model = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=8)
    tw.init_parameters(model, torch.Generator().manual_seed(0))
    forwards = []
    for layer in model.wav2vec2.encoder.layers:  # counted in forward: a recompute runs no module hooks
        layer.forward = lambda *a, f=layer.forward, **k: forwards.append(1) or f(*a, **k)
    rng = np.random.default_rng(1)
    mask = np.arange(1600)[None, :] < np.asarray(LENGTHS)[:, None]
    batch = {"features": torch.from_numpy(rng.normal(0, 0.5, (4, 1600)).astype(np.float32) * mask),
             "mask": torch.from_numpy(mask), "labels": torch.tensor([0, 3, 5, 7])}
    gen = torch.Generator().manual_seed(11)
    loss, _ = ttask.SpeakerTask(model, "ce").loss_fn(batch, gen, train=True)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, gen.get_state(), len(forwards), model.wav2vec2.encoder.layers_run


@pytest.mark.parametrize("hash_dropout", [True, False], ids=["hash", "bernoulli"])
@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_remat_step_is_bit_equal_to_the_plain_step(policy, hash_dropout):
    want = _step(False, "nothing", hash_dropout)
    got = _step(True, policy, hash_dropout)
    kept = want[4]
    assert 0 < kept < TINY["num_layers"]  # layerdrop kept some layers and skipped others
    assert want[3] == kept and got[3] == 2 * kept  # each kept layer recomputed once in the backward
    assert torch.equal(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    for name, g in want[1].items():
        assert torch.equal(got[1][name], g), name
    assert torch.equal(got[2], want[2])


def test_remat_leaves_forwards_without_gradients_alone():
    """An eval forward of a remat model runs each layer once, without
    ``checkpoint``, and equals the plain model's."""
    model = tw.Wav2Vec2Model(tw.Wav2Vec2Config(**TINY, remat=True)).eval()
    tw.init_parameters(model, torch.Generator().manual_seed(0))
    plain = tw.Wav2Vec2Model(tw.Wav2Vec2Config(**TINY)).eval()
    plain.load_state_dict(model.state_dict())
    forwards = []
    for layer in model.encoder.layers:
        layer.forward = lambda *a, f=layer.forward, **k: forwards.append(1) or f(*a, **k)
    wav = torch.randn(2, 1600)
    with torch.no_grad():
        assert torch.equal(model(wav)[0], plain(wav)[0])
    assert len(forwards) == TINY["num_layers"]


def test_deterministic_mode_sets_and_restores_the_flags():
    cudnn = torch.backends.cudnn
    before = (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(False)
    cudnn.benchmark = True
    try:
        with texp.deterministic_mode(True, torch.device("cpu")):
            assert torch.are_deterministic_algorithms_enabled()
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
            assert cudnn.deterministic and not cudnn.benchmark
        assert not torch.are_deterministic_algorithms_enabled() and cudnn.benchmark and not cudnn.deterministic
        with texp.deterministic_mode(False, torch.device("cpu")):
            assert not torch.are_deterministic_algorithms_enabled()
        with pytest.raises(KeyError), texp.deterministic_mode(True, torch.device("cpu")):
            raise KeyError("a failed run")
        assert not torch.are_deterministic_algorithms_enabled() and cudnn.benchmark
    finally:
        torch.use_deterministic_algorithms(before[0])
        cudnn.deterministic, cudnn.benchmark = before[1], before[2]


def test_cublas_workspace_is_set_before_cuda_work_or_refused(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG=:4096:8"):
        texp._cublas_workspace()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    texp._cublas_workspace()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    texp._cublas_workspace()  # set already: nothing to refuse


@pytest.mark.parametrize("recipe", ["speech_wav2vec2_ctc", "speaker_wav2vec2_ctc", "multitask_wav2vec2",
                                    "speaker_wav2vec2_ce"])
def test_deterministic_ctc_training_is_refused_on_the_card(recipe):
    """Once refused (``F.ctc_loss``'s CUDA backward sums with atomics), CTC
    training under ``trainer.deterministic=true`` is now accepted: the CTC
    loss runs ``ops/ctc.py``'s kernels, which use none. Every recipe, CTC or
    not, passes ``check_deterministic`` with and without the flag and
    without training, and a flag that is not a bool still raises; a CTC
    recipe's loss routes through ``ops.ctc`` (its plain version here)."""
    from w2v2_speaker_tpu_torch.objectives import losses as tlosses
    from w2v2_speaker_tpu_torch.ops import ctc

    cfg = texp.load_recipe(recipe, ["trainer.deterministic=true"])
    texp.check_deterministic(cfg)
    texp.check_deterministic({**cfg, "fit_model": False})
    texp.check_deterministic(texp.load_recipe(recipe))
    texp._check_ported(cfg)
    with pytest.raises(ValueError, match="must be a bool"):
        texp.check_deterministic(texp.load_recipe(recipe, ["trainer.deterministic=1"]))
    if cfg["optim"]["loss"]["name"].startswith("ctc"):
        counters = (ctc.ctc_alpha_beta, ctc.ctc_grad)
        before = [c.launches for c in counters]
        logits = torch.randn(2, 6, 5, requires_grad=True)
        loss = tlosses.ctc_loss(logits, torch.tensor([6, 4]), torch.tensor([[1, 2], [3, 0]]), torch.tensor([2, 1]))
        loss.backward()
        assert torch.isfinite(loss) and logits.grad.abs().sum() > 0
        assert [c.launches for c in counters] == before  # the CPU runs the plain versions
