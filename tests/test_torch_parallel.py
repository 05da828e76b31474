"""The port's parallel/ package in one process: the mesh helpers against the
JAX package's, the process group's entry and single-process behaviour, the
non-chief loop, and the mel cache that ranks share.

The two-process group itself runs in tests/test_torch_parallel_steps.py.
"""

import os

import numpy as np
import pytest
import torch

from gantron_tpu.parallel import pad_batch_rows as jax_pad_batch_rows
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.data import toy
from gantron_tpu_torch.data.dataset import TextMelDataset
from gantron_tpu_torch.parallel import distributed
from gantron_tpu_torch.parallel.mesh import (make_mesh, pad_batch_rows,
                                             shard_batch)
from gantron_tpu_torch.train import loop
from gantron_tpu_torch.train.checkpoint import CheckpointManager
from gantron_tpu_torch.train.step import Batch
from test_torch_loop import port_hp
from torch_threads import one_torch_thread  # noqa: F401
from test_train_step import synth_batch, tiny_hp


def numpy_batch(B):
    return Batch(*(np.array(x) for x in synth_batch(tiny_hp(), B=B)))


@pytest.mark.parametrize("rows,multiple", [(5, 2), (5, 4), (6, 3), (1, 8)])
def test_pad_batch_rows_matches_jax(rows, multiple):
    """Repeat-padding of the last row, bit-equal to the JAX package's, on
    numpy arrays and on tensors."""
    batch = numpy_batch(rows)
    want = jax_pad_batch_rows(batch, multiple)
    got = pad_batch_rows(batch, multiple)
    as_tensors = pad_batch_rows(Batch(*map(torch.from_numpy, batch)),
                                multiple)
    assert type(got) is Batch and got.text.shape[0] % multiple == 0
    for w, g, t in zip(want, got, as_tensors):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_shard_batch_takes_contiguous_row_ranges():
    batch = numpy_batch(8)
    for world in (1, 2, 4):
        shards = [shard_batch(batch, r, world) for r in range(world)]
        for name in Batch._fields:
            np.testing.assert_array_equal(
                np.concatenate([getattr(s, name) for s in shards]),
                getattr(batch, name))
        assert all(s.text.shape[0] == 8 // world for s in shards)
    np.testing.assert_array_equal(shard_batch(batch, 1, 4).mels,
                                  batch.mels[2:4])
    with pytest.raises(ValueError, match="6 rows do not split over 4"):
        shard_batch(numpy_batch(6), 0, 4)


def test_make_mesh_needs_one_process_a_device():
    assert make_mesh(None) == ((1,), 1, 0)
    assert make_mesh([1]).size == 1
    for shape in ([2], [2, 2]):
        with pytest.raises(ValueError, match="but the process group has 1 "
                           "process"):
            make_mesh(shape)


def test_initialize_multihost_without_a_cluster_is_one_process(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_multihost() == 0
    assert not distributed.in_group()
    assert (distributed.process_index(), distributed.process_count()) == \
        (0, 1)
    assert distributed.is_chief() and distributed.rank_seed(7) == 7
    distributed.barrier("alone")
    x = torch.arange(4.0, requires_grad=True)
    assert distributed.all_reduce_sum(x) is x
    t = [torch.ones(3)]
    assert distributed.all_reduce_mean_(t)[0].tolist() == [1.0] * 3
    assert distributed.broadcast_(t)[0].tolist() == [1.0] * 3


def test_initialize_multihost_raises_on_a_bad_explicit_cluster():
    """Explicit arguments that cannot form the group raise: an address
    whose port another socket holds, a rank outside the group, half the
    trio; and the process stays out of any group."""
    import socket

    with socket.socket() as held:
        held.bind(("localhost", 0))
        held.listen()
        port = held.getsockname()[1]
        with pytest.raises(RuntimeError, match="address already in use"):
            distributed.initialize_multihost(f"localhost:{port}", 2, 0,
                                             backend="gloo", timeout_s=10)
    with pytest.raises(ValueError, match="outside"):
        distributed.initialize_multihost("localhost:1", 2, 2)
    with pytest.raises(ValueError, match="needs both"):
        distributed.initialize_multihost(num_processes=2)
    with pytest.raises(ValueError, match="not host:port"):
        distributed.initialize_multihost("localhost", 2, 0)
    assert not distributed.in_group()


def test_non_chief_loop_writes_nothing(tmp_path, monkeypatch):
    """A non-chief process (rank patched to 1, as tests/test_multihost.py
    does for the JAX loop) trains, validates and would save, but writes no
    checkpoint, media or metrics, and lists no checkpoint to resume."""
    from test_loop import tiny_hp as loop_tiny_hp

    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    hp = port_hp(loop_tiny_hp(iterations=2, iters_per_checkpoint=2,
                              batch_size=8, text_buckets=[12],
                              mel_buckets=[24]))
    out = tmp_path / "out"
    state, it = loop.train(str(out), None, False, hp, "synthetic",
                           device="cpu")
    assert it == 2 and state.step == 2
    assert not out.exists()
    ckpt = CheckpointManager(str(out))
    assert ckpt.save(state, 2, 1.0) is None and ckpt.latest() is None
    assert ckpt.best() is None and not out.exists()


def test_mel_cache_is_written_whole_then_renamed(tmp_path, monkeypatch):
    """Each cache file is written under a name of its own process in the
    cache's directory and renamed into place, so a rank featurizing the
    same cold utterance never loads half a file; none is left behind."""
    wav_dir, train, _ = toy.build_corpus(str(tmp_path), n_utts=2,
                                         n_train=2, seed=1)
    hp = HParams()
    hp.add_params(dict(text_buckets=[16], mel_buckets=[40]))
    cache = tmp_path / "cache"
    ds = TextMelDataset([train], hp, wav_dir, str(cache), device="cpu")
    renames = []
    real_replace = os.replace

    def replace(src, dst):
        assert os.path.exists(src) and not os.path.exists(dst)
        renames.append((src, dst))
        real_replace(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    mels = [ds.get_mel(path) for path, *_ in ds.entries]
    assert [dst for _, dst in renames] == [ds._mel_path(p)
                                           for p, *_ in ds.entries]
    for src, dst in renames:
        assert os.path.dirname(src) == os.path.dirname(dst)
        assert src.endswith(f".{os.getpid()}.tmp")
    assert sorted(os.listdir(cache)) == sorted(
        os.path.basename(d) for _, d in renames)
    for (_, dst), mel in zip(renames, mels):
        np.testing.assert_array_equal(np.load(dst), mel)
