"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points (``predict`` too) need a card unless asked for
the CPU, training and the fused conv route run, and what is not ported yet
raises."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

from w2v2_speaker_tpu_torch import device as tdevice
from w2v2_speaker_tpu_torch.entry import dryrun_multichip, entry, large_train_entry, train_entry
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.ops import conv_encoder

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
    assert len(files) > 10 and ROOT / "w2v2_speaker_tpu_torch" / "predict.py" in files
    assert ROOT / "tools" / "torch_parallel_cases.py" in files
    for module in ("run.py", "data/datamodule.py", "data/shards.py", "data/batching.py", "data/chunks.py",
                   "data/extract.py", "data/augment.py", "runtime/logging.py", "runtime/tb_writer.py",
                   "train/checkpoint.py", "models/pooling.py", "models/wav2vec2_paired.py", "train/paired_task.py",
                   "utils/native.py", "runtime/debug.py", "models/wav2vec1.py", "runtime/lr_find.py",
                   "runtime/progress.py", "runtime/sweeper.py", "runtime/slurm.py", "runtime/completion.py",
                   "objectives/schedules.py", "train/state.py", "ops/quant.py", "parallel/mesh.py",
                   "parallel/tp.py"):
        assert ROOT / "w2v2_speaker_tpu_torch" / module in files, module
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_the_jax_export_tool_is_not_a_port_tool():
    """``tools/export_jax_params.py`` imports the JAX package (it restores
    orbax checkpoints), so it lives outside both packages and outside the
    ``tools/torch_*`` files that this module holds to the port's rules."""
    tool = ROOT / "tools" / "export_jax_params.py"
    assert tool.exists() and not tool.name.startswith("torch_")
    assert tool not in sorted((ROOT / "tools").glob("torch_*.py"))
    assert any(name.split(".")[0] == "w2v2_speaker_tpu" for name in _imported_modules(tool))


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        large_train_entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="asks for 2 cards"):  # before any rank starts
        dryrun_multichip(2)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.resolve_device("meta")


def test_train_and_fused_conv_raise():
    """train=True runs (and raises only without the step's generator);
    the fused conv route builds and trains at a tiny eligible width (on
    the CPU through the plain version); int8, which once raised, serves on
    the CPU through the plain versions (no kernel launch) and refuses to
    train."""
    model = tw.Wav2Vec2Model(TINY)
    tw.init_parameters(model, torch.Generator().manual_seed(0))
    x, _ = model(torch.randn(2, 400), train=True, generator=torch.Generator().manual_seed(0))
    assert x.shape == (2, 79, 16) and torch.isfinite(x).all()
    x.sum().backward()
    assert model.feature_projection.projection.weight.grad is not None
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros(1, 400), train=True)
    fused = tw.Wav2Vec2Model(dataclasses.replace(
        TINY, conv_dim=(128, 128), conv_kernel=(10, 3), conv_stride=(5, 2),
        feat_extract_norm="layer", conv_bias=True, conv_impl="fused_pallas"))
    tw.init_parameters(fused, torch.Generator().manual_seed(0))
    before = conv_encoder.strided_conv_fused.launches
    x, _ = fused(torch.randn(2, 400), train=True, generator=torch.Generator().manual_seed(0))
    assert x.shape == (2, 39, 16) and torch.isfinite(x).all()
    x.sum().backward()
    assert conv_encoder.strided_conv_fused.launches == before  # no kernel on the CPU
    grad = fused.feature_encoder.conv_1.weight.grad
    assert grad is not None and grad.abs().sum() > 0 and fused.feature_encoder.layer_norm_1.bias.grad is not None
    from w2v2_speaker_tpu_torch.ops import quant

    int8 = tw.Wav2Vec2Model(dataclasses.replace(TINY, int8_matmuls=True))
    tw.init_parameters(int8, torch.Generator().manual_seed(0))
    launched = (quant.quantize_rows.launches, quant.int8_gemm.launches)
    with torch.no_grad():
        x, _ = int8(torch.randn(2, 400))
    assert x.shape == (2, 79, 16) and torch.isfinite(x).all()
    assert (quant.quantize_rows.launches, quant.int8_gemm.launches) == launched  # no kernel on the CPU
    with pytest.raises(RuntimeError, match="inference only"):
        int8(torch.randn(2, 400), train=True, generator=torch.Generator().manual_seed(0))


def test_predict_needs_a_card_before_reading_audio(tmp_path):
    """``python -m w2v2_speaker_tpu_torch.predict`` on a host without a card
    raises "no CUDA device" before it reads the (missing) pair file."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "w2v2_speaker_tpu_torch.predict", "network=wav2vec2_fc",
         f"predict_folder_path={tmp_path / 'missing'}", f"pair_prediction_path={tmp_path / 'missing.txt'}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "missing.txt" not in proc.stderr, proc.stderr[-2000:]
    assert not (tmp_path / "missing").exists()


def test_run_needs_a_card_before_reading_data(tmp_path):
    """``python -m w2v2_speaker_tpu_torch.run`` on a host without a card
    raises "no CUDA device" before it looks for the (missing) corpus or
    writes a shard."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "w2v2_speaker_tpu_torch.run", "+experiment=speaker_wav2vec2_ce",
         f"data.module.data_dir={tmp_path / 'missing'}", f"data.module.shards_dir={tmp_path / 'shards'}",
         f"trainer.checkpoint_dir={tmp_path / 'ckpt'}", "trainer.log_dir=null"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "missing" not in proc.stderr, proc.stderr[-2000:]
    assert not (tmp_path / "shards").exists() and not (tmp_path / "ckpt").exists()
