"""``parallel/mesh.py``'s row layout and the dropout draws at global
coordinates, on the CPU, no process group.

- ``select_rows`` gives each data rank the rows that
  ``jax.device_put(x, batch_sharding(mesh))`` puts on that device, on 2-
  and 4-device meshes, per microbatch with ``acc=2`` (the JAX step cuts
  the global batch into microbatches first) and along axis 1 of stacked
  ``[K, B]`` batches (``stacked_batch_sharding``);
- ``pad_batch_rows`` equals the JAX package's;
- the hash masks of a row block, of a head block and of a column block
  (``attention_dropout_keep`` ``coords``, ``hash_dropout`` ``row0`` /
  ``cols``) are bit-for-bit the global mask's entries, and the global mask
  the JAX package's; the Bernoulli masks, span-mask uniforms and random
  pooling draws of a rank in a sharded microbatch are the global draws'
  rows (every rank's generator draws the global shape).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2v2_speaker_tpu.ops.flash_attention import attention_dropout_keep as jax_keep
from w2v2_speaker_tpu.parallel import mesh as jmesh
from w2v2_speaker_tpu_torch.models.masking import draw_row_uniform
from w2v2_speaker_tpu_torch.models.wav2vec2 import HashDropout, hash_dropout
from w2v2_speaker_tpu_torch.ops.flash_attention import attention_dropout_keep
from w2v2_speaker_tpu_torch.parallel.mesh import Mesh, pad_batch_rows, row_indices, select_rows, shard_rows

RATE = 0.3


def _mesh(rank, world):
    return Mesh(rank, world, 1, torch.device("cpu"))


@pytest.mark.parametrize("devices, acc, stacked", [
    (2, 1, False), (4, 1, False), (2, 2, False), (4, 2, False), (2, 1, True), (4, 2, True)])
def test_select_rows_matches_jax_batch_sharding(devices, acc, stacked):
    b, k = 16, 3
    ids = np.arange(k * b).reshape(k, b) if stacked else np.arange(b)
    mesh = jmesh.create_mesh(jax.devices()[:devices])
    order = list(mesh.devices.flatten())
    want = {d: [] for d in range(devices)}
    for m in range(acc):
        micro = ids[..., m * b // acc:(m + 1) * b // acc]
        sharding = jmesh.stacked_batch_sharding(mesh) if stacked else jmesh.batch_sharding(mesh)
        for shard in jax.device_put(micro, sharding).addressable_shards:
            want[order.index(shard.device)].append(np.asarray(shard.data))
    for d in range(devices):
        got = select_rows({"x": ids, "keys": ["host only"]}, _mesh(d, devices), acc, stacked)
        assert list(got) == ["x"]
        np.testing.assert_array_equal(got["x"], np.concatenate(want[d], axis=1 if stacked else 0))
        np.testing.assert_array_equal(row_indices(b, devices, d, acc), got["x"][0] if stacked else got["x"])


def test_select_rows_refuses_rows_that_do_not_split():
    with pytest.raises(ValueError, match="not divisible by 2 microbatches x 2 data ranks"):
        select_rows({"x": np.arange(6)}, _mesh(0, 2), acc=2)


@pytest.mark.parametrize("mask_fill", [False, True])
def test_pad_batch_rows_matches_jax(mask_fill):
    rng = np.random.default_rng(0)
    batch = {"features": rng.normal(size=(5, 7)).astype(np.float32), "mask": rng.random((5, 7)) > 0.3,
             "labels": rng.integers(0, 9, 5)}
    got, want = pad_batch_rows(batch, 8, mask_fill), jmesh.pad_batch_rows(batch, 8, mask_fill)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("seed", [0, -123456789, 2**31 - 2])
def test_row_and_head_blocks_are_the_global_mask(seed):
    b, h, t = 6, 4, 9
    full = attention_dropout_keep(seed, b, h, t, t, RATE)
    np.testing.assert_array_equal(full.numpy(), np.asarray(jax_keep(jnp.int32(seed), b, h, t, t, RATE)))
    for row0, rows in ((0, 3), (3, 3), (2, 2)):
        got = attention_dropout_keep(seed, rows, h, t, t, RATE, coords=(row0, 0, 0))
        assert torch.equal(got, full[row0:row0 + rows])
        for head0, heads in ((0, 2), (2, 2), (1, 3)):
            got = attention_dropout_keep(seed, rows, heads, t, t, RATE, coords=(row0, head0, h))
            assert torch.equal(got, full[row0:row0 + rows, head0:head0 + heads])


def test_hash_dropout_blocks_are_the_global_mask():
    x = torch.randn(6, 5, 12)
    full = hash_dropout(x, RATE, 77)
    assert torch.equal(hash_dropout(x[2:4], RATE, 77, row0=2), full[2:4])
    assert torch.equal(hash_dropout(x[4:, :, 6:], RATE, 77, row0=4, cols=(6, 12)), full[4:, :, 6:])


@pytest.mark.parametrize("use_hash", [True, False])
def test_rank_draws_are_the_global_draws_rows(use_hash):
    """Two ranks, each with the step generator seeded alike, inside a
    sharded microbatch of 3 rows each: their Bernoulli (or hash) dropout,
    span-mask uniforms and random pooling draws are the global draws'
    rows, and the rank's dropout output is the global output's rows."""
    x = torch.randn(6, 4, 8)
    site = HashDropout(RATE, use_hash)
    gen = torch.Generator().manual_seed(3)
    want_noise = site.draw(x.shape, gen)
    want = site.apply(x, want_noise)
    want_u = draw_row_uniform(gen, (6, 4), x.device)
    for rank in (0, 1):
        gen = torch.Generator().manual_seed(3)
        with shard_rows(_mesh(rank, 2), 3) as s:
            assert (s.offset, s.rows, s.total) == (3 * rank, 3, 6)
            local = x[s.offset:s.offset + 3]
            got = site.apply(local, site.draw(local.shape, gen))
            got_u = draw_row_uniform(gen, (3, 4), x.device)
        assert torch.equal(got, want[3 * rank:3 * rank + 3])
        assert torch.equal(got_u, want_u[3 * rank:3 * rank + 3])
