"""HF wav2vec2 checkpoints into the port (``models/hf_convert.py``): HF models
built from a ``transformers.Wav2Vec2Config`` (no download) in the BASE
layout (group norm on conv 0, post-norm) and the LARGE layout (a LayerNorm
after every conv, conv bias, pre-norm), written as ``.bin`` (both weight-norm
key forms of the pos conv) and ``.safetensors``. The port's forward matches
HF's ``last_hidden_state`` at rtol 1e-4 / atol 1e-5; its state dict is the
JAX package's ``hf_state_dict_to_flax`` tree carried over by
``params_from_jax``, exactly, and its forward matches the JAX package's at
1e-4 / 1e-5. The safetensors reader matches ``safetensors``' own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models.wav2vec2_convert import hf_state_dict_to_flax
from w2v2_speaker_tpu_torch.models import hf_convert
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models.convert import params_from_jax

TINY = dict(  # tests/test_wav2vec2_parity.py's geometry
    conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), hidden_size=64,
    num_layers=3, num_heads=4, intermediate_size=128, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)
LAYOUTS = {
    "base": dict(feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False),
    "large": dict(feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True),
}
RTOL, ATOL = 1e-4, 1e-5


def _hf_model(layout):
    from transformers import Wav2Vec2Config as HFConfig
    from transformers import Wav2Vec2Model as HFModel

    torch.manual_seed(0)
    model = HFModel(HFConfig(
        conv_dim=list(TINY["conv_dim"]), conv_kernel=list(TINY["conv_kernel"]),
        conv_stride=list(TINY["conv_stride"]), hidden_size=TINY["hidden_size"],
        num_hidden_layers=TINY["num_layers"], num_attention_heads=TINY["num_heads"],
        intermediate_size=TINY["intermediate_size"],
        num_conv_pos_embeddings=TINY["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=TINY["num_conv_pos_embedding_groups"],
        num_feat_extract_layers=len(TINY["conv_dim"]), **LAYOUTS[layout],
    ))
    with torch.no_grad():  # non-trivial norm parameters and biases
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape))
    return model.eval()


def _write(hf, path, form):
    sd = {k: v.contiguous() for k, v in hf.state_dict().items()}
    if form == "weight_norm":  # the classic torch.nn.utils.weight_norm names
        pos = "encoder.pos_conv_embed.conv."
        sd[pos + "weight_g"] = sd.pop(pos + "parametrizations.weight.original0")
        sd[pos + "weight_v"] = sd.pop(pos + "parametrizations.weight.original1")
        sd = {f"wav2vec2.{k}": v for k, v in sd.items()}  # a Wav2Vec2ForCTC-style dump
    if path.suffix == ".safetensors":
        from safetensors.torch import save_file

        save_file(sd, str(path))
    else:
        torch.save(sd, path)


@pytest.mark.parametrize("fmt, form", [(".bin", "parametrizations"), (".bin", "weight_norm"),
                                       (".safetensors", "parametrizations")])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_hf_checkpoint_matches_hf_and_jax(tmp_path, layout, fmt, form):
    hf = _hf_model(layout)
    path = tmp_path / f"model{fmt}"
    _write(hf, path, form)
    cfg = tw.Wav2Vec2Config(**TINY, **LAYOUTS[layout])
    sd = hf_convert.load_hf_checkpoint(path, cfg)
    model = tw.Wav2Vec2Model(cfg).eval()
    model.load_state_dict(sd, strict=False)
    missing = set(model.state_dict()) - set(sd)
    assert missing == {"masked_spec_embed"} or (not missing and "masked_spec_embed" in sd), missing

    jcfg = jw.Wav2Vec2Config(**TINY, **LAYOUTS[layout])
    flax = hf_state_dict_to_flax(hf.state_dict(), jcfg)
    want_sd = params_from_jax(jax.device_get(flax), cfg)
    assert sorted(sd) == sorted(want_sd)
    for name, value in want_sd.items():
        assert torch.equal(sd[name], value), name

    wav = np.random.default_rng(0).normal(size=(2, 3200)).astype(np.float32)
    with torch.no_grad():
        want_hf = hf(torch.from_numpy(wav)).last_hidden_state.numpy()
        got, _ = model(torch.from_numpy(wav))
    np.testing.assert_allclose(got.numpy(), want_hf, rtol=RTOL, atol=ATOL)
    want_jax, _ = jw.Wav2Vec2Model(cfg=jcfg).apply({"params": flax}, jnp.asarray(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=RTOL, atol=ATOL)


def _write_tiny_hf(path):
    """A HF model of the run twin's tiny geometry written to ``path``."""
    from w2v2_speaker_tpu_torch.runtime.experiment import TINY_W2V2 as tiny

    from transformers import Wav2Vec2Config as HFConfig
    from transformers import Wav2Vec2Model as HFModel

    torch.manual_seed(1)
    hf = HFModel(HFConfig(
        conv_dim=list(tiny.conv_dim), conv_kernel=list(tiny.conv_kernel), conv_stride=list(tiny.conv_stride),
        hidden_size=tiny.hidden_size, num_hidden_layers=tiny.num_layers, num_attention_heads=tiny.num_heads,
        intermediate_size=tiny.intermediate_size, num_conv_pos_embeddings=tiny.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=tiny.num_conv_pos_embedding_groups,
        num_feat_extract_layers=len(tiny.conv_dim)))
    _write(hf, path, "parametrizations")


def test_pretrained_checkpoint_is_grafted_into_the_backbone(tmp_path):
    """``network.pretrained_checkpoint`` in a predict model: the converted
    backbone replaces the init, the head keeps it."""
    from w2v2_speaker_tpu_torch.runtime.config import load_config
    from w2v2_speaker_tpu_torch.runtime.experiment import CONFIG_DIR
    from w2v2_speaker_tpu_torch.runtime.predict import build_predict_model

    _write_tiny_hf(tmp_path / "hf.safetensors")
    overrides = ["network=wav2vec2_fc", "network.wav2vec2_size=tiny", "trainer.precision=f32"]
    plain = build_predict_model(load_config(CONFIG_DIR, "predict", overrides), "cpu")
    warm = build_predict_model(load_config(CONFIG_DIR, "predict", [
        *overrides, f"network.pretrained_checkpoint={tmp_path / 'hf.safetensors'}"]), "cpu")
    converted = hf_convert.load_hf_checkpoint(tmp_path / "hf.safetensors", warm.cfg.w2v2)
    for name, value in warm.state_dict().items():
        short = name.removeprefix("wav2vec2.")
        if short in converted and name.startswith("wav2vec2."):
            assert torch.equal(value, converted[short]), name
        else:
            assert torch.equal(value, plain.state_dict()[name]), name


def test_safetensors_reader_matches_the_library(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f16": rng.normal(size=(7,)).astype(np.float16),
        "f64": rng.normal(size=(2, 2, 2)),
        "i64": rng.integers(-9, 9, (4,)),
        "i32": rng.integers(-9, 9, (1, 3)).astype(np.int32),
        "u8": rng.integers(0, 255, (6,)).astype(np.uint8),
        "scalar": np.full((), 3.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }
    save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got = hf_convert.read_safetensors(tmp_path / "a.safetensors")
    want = load_file(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype and got[name].shape == value.shape, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    bf16 = torch.randn(4, 3).to(torch.bfloat16)
    save_torch({"w": bf16}, str(tmp_path / "b.safetensors"))
    np.testing.assert_array_equal(hf_convert.read_safetensors(tmp_path / "b.safetensors")["w"],
                                  bf16.float().numpy())


def test_pretrained_checkpoint_leaves_the_paired_model_at_init(tmp_path, capsys):
    """The paired network has no ``wav2vec2`` subtree, so ``_init_state``
    reads ``network.pretrained_checkpoint`` and keeps every weight at its
    initialisation, as the JAX package's ``_init_state`` does (it grafts
    only into a ``wav2vec2`` subtree), and prints that it did not load it."""
    from w2v2_speaker_tpu_torch.runtime import experiment as texp

    _write_tiny_hf(tmp_path / "hf.safetensors")
    cfg = texp.load_recipe("speaker_wav2vec2_pairs", [
        "network.wav2vec2_size=tiny", "trainer.precision=f32",
        f"network.pretrained_checkpoint={tmp_path / 'hf.safetensors'}"])
    task, kind = texp.build_model_and_task(cfg, 0)
    tw.init_parameters(task.model, torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in task.model.state_dict().items()}
    state = texp._init_state(cfg, task)
    converted = hf_convert.load_hf_checkpoint(tmp_path / "hf.safetensors", task.model.cfg.w2v2)
    assert kind == "paired" and state.model is task.model
    assert sum(name in converted for name in init) == len(init) - 2  # the file matches all but equality_head
    for name, value in task.model.state_dict().items():
        assert torch.equal(value, init[name]), name
    assert "the checkpoint is not loaded, as in the JAX package" in capsys.readouterr().out
