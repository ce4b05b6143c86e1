"""Data-parallel train steps of the port, for the CPU tests and the card.

``step_case(case, mesh)`` builds a case's model and task from plain data
(``case``: ``kind`` "speaker", "xvector" or "speech", the config fields,
a ``state_dict``, a numpy ``batch``, ``mode``, ``acc``, ``seed``,
``device``, the CPU by default, and ``tf32``), runs one
``make_train_step`` step on this rank's rows (``select_rows``) and returns
the loss, the reduced gradients and the updated parameters and buffers.
``rank_cases(cases)`` runs every case on each rank of the world it is
spawned in (``parallel.mesh.spawn``) and adds, per case, whether every
rank's parameters and buffers are bit-identical after the step. On the
card a world of gloo ranks may share one card, and a world of 1 over NCCL
makes one NCCL all-reduce besides. ``split_step_case(case, world)`` runs,
in one process, each data rank's share of a ``world``-rank step in turn
and sums the reduced gradients: what the ranks compute, without a second
process. ``predict_rank(argv, device)`` runs the
predict twin on each rank of the world it is spawned in and returns every
rank's record (its score file, the files it saved, what it printed).

    from w2v2_speaker_tpu_torch.parallel.mesh import spawn
    results = spawn(rank_cases, (cases,), nprocs=2, deadline=120, timeout=60, threads=1)
"""

from __future__ import annotations

import contextlib
import hashlib
import io
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from w2v2_speaker_tpu_torch.data.features import FbankConfig
from w2v2_speaker_tpu_torch.data.tokenizer import CharTokenizer
from w2v2_speaker_tpu_torch.device import set_float32_precision
from w2v2_speaker_tpu_torch.models.frontend import FbankFrontend
from w2v2_speaker_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from w2v2_speaker_tpu_torch.models.wav2vec2_speaker import Wav2Vec2SpeakerConfig, Wav2Vec2SpeakerModel
from w2v2_speaker_tpu_torch.models.wav2vec2_speech import Wav2Vec2SpeechConfig, Wav2Vec2SpeechModel
from w2v2_speaker_tpu_torch.models.xvector import XVectorConfig, XVectorModel
from w2v2_speaker_tpu_torch.parallel.mesh import Mesh, create_mesh, select_rows
from w2v2_speaker_tpu_torch.train.speaker_task import SpeakerTask
from w2v2_speaker_tpu_torch.train.speech_task import SpeechTask
from w2v2_speaker_tpu_torch.train.state import AdamTx, TrainState
from w2v2_speaker_tpu_torch.train.steps import make_train_step

__all__ = ["build", "predict_rank", "rank_cases", "split_step_case", "step_case"]


def build(case: Dict):
    """(model, task) of ``case``, its ``state_dict`` loaded strictly."""
    kind = case["kind"]
    if kind == "xvector":
        model = FbankFrontend(XVectorModel(XVectorConfig(**case["config"]), case["speakers"]),
                              FbankConfig(n_mels=case["config"]["in_channels"]))
        task = SpeakerTask(model, "ce")
    elif kind == "speech":
        cfg = Wav2Vec2SpeechConfig(w2v2=Wav2Vec2Config(**case["w2v2"]), **case["config"])
        model = Wav2Vec2SpeechModel(cfg)
        task = SpeechTask(model, CharTokenizer(case["vocab"]))
    else:
        cfg = Wav2Vec2SpeakerConfig(w2v2=Wav2Vec2Config(**case["w2v2"]), **case["config"])
        model = Wav2Vec2SpeakerModel(cfg, num_speakers=case["speakers"])
        task = SpeakerTask(model, case.get("mode", "ce"))
    model.load_state_dict(case["state_dict"], strict=True)
    return model.to(case.get("device", "cpu")), task


def step_case(case: Dict, mesh: Optional[Mesh] = None) -> Dict:
    """One step of ``case`` on this rank's rows of its global batch, in
    full float32 (``set_float32_precision``, as every entry point of the
    port sets it for the card: a spawned rank starts with PyTorch's
    defaults, under which cuDNN runs float32 convolutions in TF32), or,
    with ``tf32`` true in ``case``, with cuDNN's TF32 left on. The result
    names the two TF32 flags the step ran under."""
    set_float32_precision()
    torch.backends.cudnn.allow_tf32 = bool(case.get("tf32", False))
    torch.manual_seed(0)
    model, task = build(case)
    acc = int(case.get("acc", 1))
    state = TrainState.create(model, AdamTx(lambda count: 1e-3), seed=int(case.get("seed", 1)))
    step = make_train_step(task, accumulate_steps=acc, mesh=mesh)
    dev = case.get("device", "cpu")
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in select_rows(case["batch"], mesh, acc).items()}
    state, metrics = step(state, batch)
    return {
        "loss": float(metrics["loss"]),
        "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
        "state": {n: v.detach().cpu() for n, v in model.state_dict().items()},
        "layers_run": int(metrics.get("layers_run", 0)),
        "tf32": (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32),
    }


def split_step_case(case: Dict, world: int = 2) -> Dict:
    """One step of ``case`` as a world of ``world`` data ranks computes it,
    in this process: data rank d's rows of each microbatch (``select_rows``)
    through the step at its global coordinates (masks, row offsets), in
    turn, over a process group of this process alone, where each all-reduce
    leaves the rank's own value: the loss means then divide by the rank's
    own rows, whose upstream gradient equals a rank's (1 / its rows'
    share), and ``all_reduce_grads`` divides by ``world``. Returns the sum
    over the ranks of their reduced gradients (every division a power of 2,
    so the sum is the ranks' all-reduced gradient up to the order of its
    one float32 addition) and each rank's loss."""
    import pathlib
    import tempfile

    made = not dist.is_initialized()
    tmp = tempfile.TemporaryDirectory(prefix="w2v2_split_")
    if made:
        dist.init_process_group("gloo", init_method=f"file://{pathlib.Path(tmp.name) / 'rendezvous'}", rank=0,
                                world_size=1)
    try:
        dev = torch.device(case.get("device", "cpu"))
        grads, losses = None, []
        for d in range(world):
            mesh = Mesh(d, world, 1, dev, "gloo", dist.group.WORLD, None, dist.group.WORLD)
            res = step_case(case, mesh)
            losses.append(res["loss"])
            grads = res["grads"] if grads is None else {n: grads[n] + g for n, g in res["grads"].items()}
        return {"grads": grads, "losses": losses}
    finally:
        if made:
            dist.destroy_process_group()
        tmp.cleanup()


def _digest(state: Dict[str, torch.Tensor]) -> str:
    h = hashlib.sha256()
    for name in sorted(state):
        h.update(name.encode())
        h.update(state[name].detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def rank_cases(cases: List[Dict], device: str = "cpu") -> List[Dict]:
    """Every case on this rank of the world (a mesh over all ranks on
    ``device``); rank 0's results, each with ``replicas_equal``: every
    rank's parameters and buffers hash alike after the step."""
    mesh = create_mesh(dist.get_world_size(), device=device)
    if mesh.backend == "nccl":
        probe = torch.ones(1, device=mesh.device)
        dist.all_reduce(probe)
        assert probe.item() == mesh.world, f"NCCL all-reduce gave {probe.item()}"
    out = []
    for case in cases:
        res = step_case({**case, "device": str(mesh.device)}, mesh)
        digests = [None] * mesh.world
        dist.all_gather_object(digests, _digest(res["state"]), group=mesh.host_group)
        res["replicas_equal"] = len(set(digests)) == 1
        out.append(res)
    return out


def predict_rank(argv: List[str], device: Optional[str] = "cpu") -> List[Dict]:
    """``w2v2_speaker_tpu_torch.predict.main(argv, device)`` on this rank of
    the world it is spawned in (``argv`` names ``trainer.num_devices``;
    ``device`` None: the card); every rank's record, gathered: its rank,
    the score file it returned, the files it saved with ``np.save``, what
    it printed and the attention-forward and conv kernels it launched."""
    from w2v2_speaker_tpu_torch import predict
    from w2v2_speaker_tpu_torch.ops import conv_encoder, flash_attention

    counters = (flash_attention.flash_attention, conv_encoder.strided_conv_fused)
    for fn in counters:
        fn.launches = 0
    saved, save = [], np.save

    def recording(path, *args, **kwargs):
        saved.append(str(path))
        return save(path, *args, **kwargs)

    out = io.StringIO()
    np.save = recording
    try:
        with contextlib.redirect_stdout(out):
            path = predict.main(argv, device=device)
    finally:
        np.save = save
    records = [None] * dist.get_world_size()
    dist.all_gather_object(records, {"rank": dist.get_rank(), "path": None if path is None else str(path),
                                     "saved": saved, "printed": out.getvalue(),
                                     "launches": [fn.launches for fn in counters]})
    return records
