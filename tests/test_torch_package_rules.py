"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points need a card unless asked for the CPU, and this
slice is eval only."""

import ast
import pathlib

import pytest
import torch

from w2v2_speaker_tpu_torch import device as tdevice
from w2v2_speaker_tpu_torch.entry import entry
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "w2v2_speaker_tpu")
TINY = tw.Wav2Vec2Config(
    conv_dim=(8,), conv_kernel=(10,), conv_stride=(5,), hidden_size=16,
    num_layers=1, num_heads=2, intermediate_size=16,
    num_conv_pos_embeddings=4, num_conv_pos_embedding_groups=2,
)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = (
        sorted((ROOT / "w2v2_speaker_tpu_torch").rglob("*.py"))
        + sorted((ROOT / "tools").glob("torch_*.py"))
        + [ROOT / "chip_smoke.py"]
    )
    assert len(files) > 10
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.resolve_device("meta")


def test_train_and_fused_conv_raise():
    model = tw.Wav2Vec2Model(TINY)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 5"):
        model(torch.zeros(1, 400), train=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 2 item 4"):
        tw.Wav2Vec2Model(tw.Wav2Vec2Config(conv_impl="fused_pallas"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 6"):
        tw.Wav2Vec2Model(tw.Wav2Vec2Config(int8_matmuls=True))
