"""int8 serving of the port (``ops/quant.py``, ``network.int8_matmuls``)
against the JAX package's ``ops/quant.py`` on the CPU, where the port's
wrappers run their plain versions (the kernels' bit-equality to those is
``tests/test_torch_cuda.py``'s, on the card).

Limits:

- the row quantize (values and scales) and the int32 sums bit-equal, on
  ``tests/test_quant.py``'s shapes with a zero row and a row whose x / scale
  lands on k + 0.5 (half to even); the float32 outputs within 2 ulps (XLA
  may contract the bias add into an FMA);
- the tiny speaker model with int8 true, port against JAX on the same
  weights: pair scores on the (s + 1) / 2 scale within 2e-3, a tenth of
  the reference's int8-against-full-precision bar (as built: 3.0e-5 in
  float32, 6.2e-5 in bfloat16: the two packages' activations differ in
  their last bits, which moves a few int8 values by one); the embeddings
  themselves within 0.012 (as built 2.4e-3 and 6.1e-3, against embeddings
  of max |e| 2.43), while the port's int8 moves its own full precision's
  embeddings by more than that (as built 0.026 and 0.033), so a full
  precision route in place of int8 fails; the port's int8 scores against
  its own full precision within 0.02 (``tests/test_quant.py:117``; as
  built 1.1e-4 and 1.2e-4);
- the predict twin against ``predict.py`` with ``int8_matmuls=auto`` on
  the reference test's corpus (``tests/test_quant.py:258``): the same
  routing line, the int8 bucket's batch through every ``QuantLinear`` in
  int8 and the full-precision bucket's through none, scores within 2e-3,
  the embeddings within 1e-3 on the int8 bucket (as built 1.5e-4, where a
  full-precision route would miss by 0.013-0.015) and 1e-5 on the full
  precision one (as built 2.4e-7).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu.ops import quant as jq
from w2v2_speaker_tpu.runtime.predict import BucketDispatchEmbed as JaxDispatch
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_speaker as ts
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.ops import quant as tq
from w2v2_speaker_tpu_torch.runtime.predict import BucketDispatchEmbed

ROOT = pathlib.Path(__file__).resolve().parents[1]
SR = 16000
SCORE_ATOL, SELF_DRIFT = 2e-3, 0.02
INT8_EMB_ATOL = 0.012  # the speaker model's int8 embeddings, port against JAX
PREDICT_INT8_EMB_ATOL, PREDICT_FULL_EMB_ATOL = 1e-3, 1e-5  # predict's embeddings a route, float32
TINY = dict(  # tests/test_quant.py's geometry
    conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), hidden_size=64, num_layers=3,
    num_heads=4, intermediate_size=128, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    layerdrop=0.0,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: at these shapes eight threads buy nothing alone
    and cost every worker of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(case):
    """x and the reference-layout kernel [K, N] of a ``tests/test_quant.py``
    case, x's second row replaced by one with absmax 127 (scale 1) whose
    other entries are k + 0.5."""
    if case == "dense":
        rng = np.random.default_rng(0)
        x = rng.normal(size=(32, 256)).astype(np.float32)
        w = (rng.normal(size=(256, 128)) * 0.05).astype(np.float32)
    else:
        rng = np.random.default_rng(1)
        x = rng.normal(size=(2, 7, 64)).astype(np.float32)
        x[0, 3] = 0.0  # a zero row: scale 1, q 0
        w = rng.normal(size=(64, 96)).astype(np.float32)
    k = x.shape[-1]
    halves = (np.arange(k) % 8 - 4 + 0.5).astype(np.float32)
    halves[0] = 127.0
    x.reshape(-1, k)[1] = halves
    return x, w


@pytest.mark.parametrize("case", ["dense", "batched_zero_row"])
def test_quantize_and_int8_matmul_match_jax(case):
    x, w = _arrays(case)
    jxq, jxs = jq._rowwise_quantize(jnp.asarray(x))
    jwq, jws = jq._rowwise_quantize(jnp.asarray(w).T)
    txq, txs = tq.quantize_rows(torch.from_numpy(x))
    twq, tws = tq.quantize_rows(torch.from_numpy(w.T.copy()))
    for got, want in ((txq, jxq), (txs, jxs[..., 0]), (twq, jwq), (tws, jws[..., 0])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k = x.shape[-1]
    q = txq.reshape(-1, k)[1].tolist()
    assert q[0] == 127 and q[1:9] == [-2, -2, 0, 0, 2, 2, 4, -4]  # -2.5 .. 3.5, -3.5: half to even
    if case != "dense":
        assert txs[0, 3] == 1 and torch.all(txq[0, 3] == 0)
    want_acc = jax.lax.dot_general(jxq.reshape(-1, k), jwq.T, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    got_acc = tq.int32_dot(txq.reshape(-1, k), twq)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    got = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)


def test_quant_linear_keeps_the_linear_layout():
    """``QuantLinear``'s parameters are ``nn.Linear``'s (names, shapes,
    initial values from one seed); with ``int8`` off it is ``nn.Linear``
    bit for bit; every dense site of an int8 backbone is a ``QuantLinear``
    and its state dict's names and shapes are the float backbone's."""
    torch.manual_seed(0)
    ref = torch.nn.Linear(32, 24)
    torch.manual_seed(0)
    got = tq.QuantLinear(32, 24)
    assert list(got.state_dict()) == list(ref.state_dict()) == ["weight", "bias"]
    for name, p in ref.state_dict().items():
        assert torch.equal(got.state_dict()[name], p)
    x = torch.randn(3, 5, 32)
    with torch.no_grad():
        assert torch.equal(tq.int8_enabled(got, False) and got(x), ref(x))
        tq.int8_enabled(got, True)
        out = got(x)
    assert out.dtype == torch.float32 and not torch.equal(out, ref(x).detach())
    cfg = tw.Wav2Vec2Config(**TINY)
    full, int8 = tw.Wav2Vec2Model(cfg), tw.Wav2Vec2Model(tw.Wav2Vec2Config(**TINY, int8_matmuls=True))
    assert {k: v.shape for k, v in full.state_dict().items()} == {k: v.shape for k, v in int8.state_dict().items()}
    assert tq.int8_enabled(int8, True) == 1 + 4 * TINY["num_layers"] and tq.int8_enabled(full, True) == 0


def test_quant_linear_refuses_a_gradient():
    """Inference only: a forward that records a gradient raises (the JAX
    ``QuantDense`` would give zero gradients through its round); a
    training step of an int8 model raises too."""
    layer = tq.QuantLinear(16, 8)
    with pytest.raises(RuntimeError, match="inference only"):
        layer(torch.randn(2, 16))
    with torch.no_grad():
        assert layer(torch.randn(2, 16)).shape == (2, 8)
    model = tw.Wav2Vec2Model(tw.Wav2Vec2Config(**TINY, int8_matmuls=True))
    with pytest.raises(RuntimeError, match="inference only"):
        model(torch.randn(2, 1600), train=True, generator=torch.Generator().manual_seed(0))


def _speaker_cfg(pkg, dtype, int8):
    w2v2 = dict(TINY, dtype=dtype, int8_matmuls=int8)
    if pkg is js:
        w2v2["attention_impl"] = "xla"  # the plain XLA attention, not the Pallas kernel in interpret mode
    mod = jw if pkg is js else tw
    return pkg.Wav2Vec2SpeakerConfig(w2v2=mod.Wav2Vec2Config(**w2v2), stat_pooling_type="mean",
                                     hidden_fc_layers_out=(), embedding_layer_idx=-1)


def _pair_scores(e):
    n = e / np.linalg.norm(e, axis=1, keepdims=True)
    return ((n @ n.T)[np.triu_indices(len(e), k=1)] + 1) / 2


@pytest.fixture(scope="module")
def jax_params():
    cfg = _speaker_cfg(js, "float32", False)
    wav = np.zeros((1, SR), np.float32)
    variables = jax.jit(js.Wav2Vec2SpeakerModel(cfg=cfg, num_speakers=8).init)({"params": jax.random.PRNGKey(0)}, wav)
    return jax.device_get(variables["params"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_speaker_model_matches_jax(jax_params, dtype):
    """The same weights through both packages' int8 speaker models
    (``QuantDense`` parameters loaded through ``models/convert.py``): pair
    scores within 2e-3 and embeddings within 0.012; the port's int8 moves
    its own full precision's embeddings by more than 0.012, and its scores
    by less than 0.02."""
    wav = (np.random.default_rng(3).normal(size=(6, SR // 2)) * 0.1).astype(np.float32)
    jm = js.Wav2Vec2SpeakerModel(cfg=_speaker_cfg(js, dtype, True), num_speakers=8)
    want = np.asarray(jax.jit(lambda p, w: jm.apply({"params": p}, w, method=js.Wav2Vec2SpeakerModel.compute_embedding))(
        jax_params, wav), np.float32)
    emb = {}
    for int8 in (True, False):
        cfg = _speaker_cfg(ts, dtype, int8)
        tm = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=8).eval()
        tm.load_state_dict(params_from_jax(jax_params, cfg))
        with torch.no_grad():
            emb[int8] = tm.compute_embedding(torch.from_numpy(wav)).float().numpy()
    scores = {k: _pair_scores(e) for k, e in emb.items()}
    cross = float(np.abs(scores[True] - _pair_scores(want)).max())
    own = float(np.abs(scores[True] - scores[False]).max())
    emb_cross, emb_own = float(np.abs(emb[True] - want).max()), float(np.abs(emb[True] - emb[False]).max())
    print(f"{dtype}: int8 port vs JAX scores {cross:.3g}, embeddings {emb_cross:.3g}; int8 vs full precision "
          f"scores {own:.3g}, embeddings {emb_own:.3g}")
    assert cross < SCORE_ATOL and emb_cross < INT8_EMB_ATOL
    assert INT8_EMB_ATOL < emb_own and own < SELF_DRIFT


def test_int8_auto_policy_matches_jax():
    for samples in (SR, 3 * SR, 6 * SR - 1, 6 * SR, 12 * SR):
        for hidden in (64, 768, 1024):
            assert tq.int8_auto_policy(samples, hidden) == jq.int8_auto_policy(samples, hidden)
            assert tq.int8_auto_policy(samples, hidden, 2 * SR) == jq.int8_auto_policy(samples, hidden, 2 * SR)
    assert tq.INT8_AUTO_MIN_SAMPLES == jq.INT8_AUTO_MIN_SAMPLES == 6 * SR


def test_bucket_dispatch_embed_routing_matches_jax():
    """Per-bucket routing and the recorded calls, as
    ``tests/test_quant.py::test_bucket_dispatch_embed_routing``."""
    short, long = np.zeros((2, SR), np.float32), np.zeros((2, 3 * SR), np.float32)
    for hidden in (768, 1024):
        got = BucketDispatchEmbed(lambda f, m=None: "full", lambda f, m=None: "int8", hidden, 2 * SR)
        want = JaxDispatch(lambda s, f, m=None: "full", lambda s, f, m=None: "int8", hidden, 2 * SR)
        assert [got(torch.from_numpy(w)) for w in (short, long)] == [want(None, w) for w in (short, long)]
        assert got.calls == want.calls
        assert got.compute_embedding(torch.from_numpy(short)) == ("full" if hidden == 768 else "int8")
    assert got.calls[-1] == (SR, True)


def test_predict_int8_auto_matches_jax(tmp_path, capsys, monkeypatch):
    """Both packages' ``predict.main`` with ``int8_matmuls=auto`` on the
    reference test's corpus (8 files of 1.0 s and 8 of 2.5 s, buckets of
    8000 samples, threshold 32 000) from the same weights (the JAX
    package's initialisation from the config's seed, as its predict makes
    it, written to ``.npz`` with ``tools/export_jax_params.py``'s
    ``flatten``): batches of 8 (the JAX
    package pads a batch to its 8-device mesh), so the 1.0 s bucket runs
    in full precision and the 2.5 s one in int8 in both, the same routing
    line; the port's int8 batch runs every ``QuantLinear`` (the projection
    and four a layer) in int8, its full-precision batch none; scores within
    2e-3, embeddings within 1e-3 (int8) and 1e-5 (full precision)."""
    import predict as jax_predict
    from w2v2_speaker_tpu.data.io import write_wav
    from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config
    from w2v2_speaker_tpu.runtime.experiment import build_model_and_task
    from w2v2_speaker_tpu.runtime.predict import _example_batch
    from w2v2_speaker_tpu_torch import predict as torch_predict
    from w2v2_speaker_tpu_torch.runtime import predict as torch_runtime

    int8_products, routes = [], []  # each int8 product's rows; (route, padded samples, int8 products) a batch
    plain_int8_matmul, plain_dispatch = tq.int8_matmul, torch_runtime.dispatch_embed

    def counted_int8_matmul(x, *args, **kwargs):
        int8_products.append(x.shape[:-1])
        return plain_int8_matmul(x, *args, **kwargs)

    def counted_dispatch(model, cfg):
        embed = plain_dispatch(model, cfg)
        for route in ("_full", "_int8"):
            def run(wav, mask=None, route=route, f=getattr(embed, route)):
                before = len(int8_products)
                out = f(wav, mask)
                routes.append((route, int(wav.shape[-1]), len(int8_products) - before))
                return out
            setattr(embed, route, run)
        return embed

    monkeypatch.setattr(tq, "int8_matmul", counted_int8_matmul)
    monkeypatch.setattr(torch_runtime, "dispatch_embed", counted_dispatch)

    rng = np.random.default_rng(7)
    wav_dir, names = tmp_path / "wav", []
    for spk, dur_s in [(0, 1.0)] * 4 + [(1, 1.0)] * 4 + [(2, 2.5)] * 4 + [(3, 2.5)] * 4:
        name = f"id{spk:05d}/yt0/{len(names):05d}.wav"
        (wav_dir / name).parent.mkdir(parents=True, exist_ok=True)
        write_wav(wav_dir / name, 0.1 * rng.normal(size=int(SR * dur_s)).astype(np.float32), SR)
        names.append(name)
    pair_file = tmp_path / "pairs.txt"
    pair_file.write_text("".join(f"{names[i]} {names[i + 1]}\n" for i in range(0, 16, 2)) + f"{names[0]} {names[8]}\n")
    argv = ["network=wav2vec2_fc", "network.wav2vec2_size=tiny", "network.layerdrop=0.0",
            "network.int8_matmuls=auto", f"network.int8_auto_min_samples={2 * SR}", "network.explicit_num_speakers=4",
            f"pair_prediction_path={pair_file}", "data.dataloader.test_batch_size=8",
            "data.dataloader.test_pad_to_multiple=8000", "trainer.precision=f32"]
    cfg = jax_load_config(ROOT / "config", "predict", argv)
    task, _ = build_model_and_task(cfg, 4)
    params, _ = jax.jit(task.init)(jax.random.PRNGKey(cfg["seed"]), _example_batch())  # predict's _init_state
    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    np.savez(tmp_path / "params.npz", **export.flatten(jax.device_get(params)))
    runs = {}
    for name in ("jax", "torch"):
        folder = tmp_path / name
        folder.symlink_to(wav_dir, target_is_directory=True)
        capsys.readouterr()
        args = [*argv, f"predict_folder_path={folder}"]
        score_file = (jax_predict.main(args) if name == "jax" else
                      torch_predict.main([*args, f"load_network_from_checkpoint={tmp_path / 'params.npz'}"],
                                         device="cpu"))
        routing = [line for line in capsys.readouterr().out.splitlines() if line.startswith("int8 auto dispatch")]
        lines = [line.split(" ") for line in score_file.read_text().splitlines()]
        runs[name] = routing, np.array([float(x[0]) for x in lines]), [x[1:] for x in lines]
        (folder / "embeddings").rename(tmp_path / f"embeddings_{name}")  # the next run extracts afresh
    assert runs["torch"][0] == runs["jax"][0] == [
        f"int8 auto dispatch: 1/2 bucket batches on int8 (threshold {2 * SR} samples)"]
    sites = 1 + 4 * 2  # the projection and four a layer of the tiny backbone's 2 layers
    assert sorted(routes) == [("_full", SR, 0), ("_int8", 5 * 8000, sites)]
    assert runs["torch"][2] == runs["jax"][2] and len(runs["torch"][1]) == 9
    np.testing.assert_allclose(runs["torch"][1], runs["jax"][1], rtol=0, atol=SCORE_ATOL)
    for i, name in enumerate(names):
        got, want = (np.load(tmp_path / f"embeddings_{pkg}" / f"{name}.npy") for pkg in ("torch", "jax"))
        assert got.shape == want.shape
        atol = PREDICT_INT8_EMB_ATOL if i >= 8 else PREDICT_FULL_EMB_ATOL  # the 2.5 s bucket on int8
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
