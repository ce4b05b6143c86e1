"""``trainer.num_devices=2`` through the ``run.py`` twin on the CPU, on
``tests/test_torch_run.py``'s corpus and recipe: the port's run on two
gloo ranks that it spawns (group timeout 60 s) against the JAX package's
2-device run and the port's 1-rank run of the same first leg
(``test_torch_run.FIRST``), and more ranks than cards raising before any
data is read. A file of its own, so that its runs and
``tests/test_torch_run.py``'s take two test workers."""

import pathlib

import numpy as np
import pytest
import torch

from test_torch_run import FIRST, LOSS_ATOL, overrides, package_runs
from w2v2_speaker_tpu_torch import run as trun
from w2v2_speaker_tpu_torch.device import DeviceError
from w2v2_speaker_tpu_torch.parallel import mesh as pmesh


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as ``tests/test_torch_run.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``FIRST`` runs (``test_torch_run.package_runs``)."""
    return package_runs(tmp_path_factory.mktemp("torch_run_parallel"), (FIRST,))


def _tb_scalars(log_dir: pathlib.Path):
    """[(step, tag, value)] of the scalar events of the TensorBoard files in
    ``log_dir``, in file order (the wire format of ``runtime/tb_writer.py``)."""
    def fields(buf):
        i, out = 0, []
        while i < len(buf):
            key, i = _varint(buf, i)
            field, wire = key >> 3, key & 7
            if wire == 0:
                val, i = _varint(buf, i)
            elif wire == 1:
                val, i = buf[i:i + 8], i + 8
            elif wire == 5:
                val, i = buf[i:i + 4], i + 4
            else:
                n, i = _varint(buf, i)
                val, i = buf[i:i + n], i + n
            out.append((field, val))
        return out

    scalars = []
    for path in sorted(log_dir.glob("events.out.tfevents.*")):
        data, i = path.read_bytes(), 0
        while i < len(data):
            n = int.from_bytes(data[i:i + 8], "little")
            event = dict(fields(data[i + 12:i + 12 + n]))
            i += 16 + n
            if 5 not in event:
                continue
            value = dict(fields(dict(fields(event[5]))[1]))
            if 2 in value:
                scalars.append((event[2], value[1].decode(), float(np.frombuffer(value[2], "<f4")[0])))
    return scalars


def _varint(buf, i):
    shift = out = 0
    while True:
        b = buf[i]
        out |= (b & 0x7F) << shift
        i, shift = i + 1, shift + 7
        if not b & 0x80:
            return out, i


def test_data_parallel_run_matches_jax_and_one_rank(runs, tmp_path, capfd, monkeypatch):
    """``trainer.num_devices=2`` on the CPU: the fixture's first run (steps
    1-4, the sanity, interval and test evaluations, checkpoint averaging)
    on two gloo ranks that the run spawns. Its per-step losses (read back
    from rank 0's TensorBoard file, float32) equal the JAX package's
    2-device run's and the port's 1-rank run's within 1e-5; its EERs and
    minDCFs equal theirs exactly (as float32), their thresholds within
    1e-5; the objective equals both."""
    corpus, rec, objectives, _, tmp = runs
    monkeypatch.setattr(pmesh, "GROUP_TIMEOUT_S", 60.0)  # the spawned ranks' groups
    argv = overrides(corpus, tmp_path, f"load_network_from_checkpoint={tmp / 'init.npz'}", *FIRST,
                     f"data.module.shards_dir={tmp / 'torch' / 'shards'}", "trainer.num_devices=2",
                     f"trainer.log_dir={tmp_path / 'tb'}")
    objective = trun.main(argv, device="cpu")
    assert "data parallel: rank 0 of 2 on cpu (gloo)" in capfd.readouterr().out
    scalars = _tb_scalars(tmp_path / "tb")
    losses = [(s, v) for s, tag, v in scalars if tag == "train/loss"]
    assert [s for s, _ in losses] == [1, 2, 3, 4]
    for name in ("jax", "torch"):
        np.testing.assert_allclose([v for _, v in losses], [v for _, v in rec.steps[name][:4]], rtol=0, atol=LOSS_ATOL)
    evals = {}
    for s, tag, v in scalars:
        split, _, key = tag.partition("/")
        if split != "train" and not key.endswith("seconds"):
            evals.setdefault((s, split, key.startswith("sanity")), {})[key] = v
    got = list(evals.values())
    for name in ("jax", "torch"):
        want = [m for _, m in rec.evals[name][:5]]
        assert [sorted(m) for m in got] == [sorted(m) for m in want]
        for g, w in zip(got, want):
            for k, v in w.items():
                assert g[k] == pytest.approx(float(np.float32(v)), rel=0, abs=1e-5 if k.endswith("threshold") else 0), k
    assert objective == objectives["jax", False] == objectives["torch", False]


def test_num_devices_above_the_cards_raises_before_reading(runs, tmp_path):
    """Two ranks asked of the card on a host without one: the run raises
    before it reads or writes anything (the JAX package would narrow to
    the devices it has)."""
    corpus, _, _, _, _ = runs
    with pytest.raises(DeviceError, match="trainer.num_devices=2 asks for 2 cards"):
        trun.main(overrides(corpus, tmp_path, "trainer.num_devices=2"))
    assert not (tmp_path / "shards").exists() and not (tmp_path / "ckpt").exists()
