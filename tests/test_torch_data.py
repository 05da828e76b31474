"""Port parity of the data path: gantron_tpu_torch's wav IO, filelists, toy
corpora, ``TextMelDataset``, ``collate`` and loaders against the JAX
package's.

The numpy copies (wav IO, filelists, toy corpora, ``collate``) are compared
exactly. Mels are compared at atol 2e-3, as the featurizer is
(tests/test_torch_audio.py): the JAX dataset pads each wav to a length
bucket and slices the true frames back, the port featurizes the true length,
so the frames agree up to float32 sum order. The port's datasets run with
``device="cpu"`` here; chip_smoke.py runs them on the card.
"""

import filecmp
import os

import numpy as np
import pytest

from gantron_tpu.config import HParams as JaxHParams
from gantron_tpu.data import dataset as jds
from gantron_tpu.data import filelists as jfl
from gantron_tpu.data import toy as jtoy
from gantron_tpu.data import wav as jwav
from gantron_tpu.utils.audio_tools import get_mel_from_audio as jax_get_mel
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.data import dataset as pds
from gantron_tpu_torch.data import filelists as pfl
from gantron_tpu_torch.data import toy as ptoy
from gantron_tpu_torch.data import wav as pwav
from gantron_tpu_torch.utils.audio_tools import get_mel_from_audio
from torch_threads import one_torch_thread  # noqa: F401


def _hps(**over):
    jhp, hp = JaxHParams(), HParams()
    over = dict(text_buckets=[16, 32], mel_buckets=[40, 80], **over)
    jhp.add_params(over)
    hp.add_params(over)
    return jhp, hp


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 6-utterance tone corpus written by the port (byte-identical to the
    JAX package's, test_toy_corpora_are_byte_identical), plus a 300-sample
    wav that is shorter than the STFT's 512-sample reflect pad."""
    root = str(tmp_path_factory.mktemp("corpus"))
    wav_dir, train, _ = ptoy.build_corpus(root, n_utts=6, n_train=6, seed=3)
    pwav.write_wav(os.path.join(wav_dir, "short.wav"),
                   np.random.RandomState(0).randn(300) * 0.1)
    with open(train, "a") as f:
        f.write("short.wav|mass\n")
    return root, wav_dir, train


def _datasets(corpus, tmp_path, **over):
    _, wav_dir, train = corpus
    jhp, hp = _hps(**over)
    jd = jds.TextMelDataset([train], jhp, wav_dir, str(tmp_path / "jax"))
    pd = pds.TextMelDataset([train], hp, wav_dir, str(tmp_path / "port"),
                            device="cpu")
    return jd, pd


@pytest.mark.parametrize("fmt", ["pcm16", "pcm24", "float32", "stereo"])
def test_wav_io_matches_jax(tmp_path, fmt):
    rng = np.random.RandomState(1)
    audio = (rng.randn(2205) * 0.3).astype(np.float32)
    jpath, ppath = str(tmp_path / "j.wav"), str(tmp_path / "p.wav")
    jwav.write_wav(jpath, audio, 16000)
    pwav.write_wav(ppath, audio, 16000)
    assert filecmp.cmp(jpath, ppath, shallow=False)
    if fmt != "pcm16":  # hand-made RIFF files of the other formats
        import struct

        ch = 2 if fmt == "stereo" else 1
        if fmt == "pcm24":
            pcm = (np.clip(audio, -1, 1) * 8388607).astype("<i4")
            raw = b"".join(struct.pack("<i", v)[:3] for v in pcm)
            code, bits = 1, 24
        else:
            x = np.repeat(audio * 1.7, ch)  # out of range: renormalized
            raw, code, bits = x.astype("<f4").tobytes(), 3, 32
        with open(ppath, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE")
            f.write(b"fmt " + struct.pack("<IHHIIHH", 16, code, ch, 16000,
                                          16000 * ch * bits // 8,
                                          ch * bits // 8, bits))
            f.write(b"data" + struct.pack("<I", len(raw)) + raw)
    for rate in (16000, 22050):
        np.testing.assert_array_equal(pwav.load_wav(ppath, rate),
                                      jwav.load_wav(ppath, rate))
    p, pr = pwav.read_wav(ppath)
    j, jr = jwav.read_wav(ppath)
    assert pr == jr and p.shape == j.shape
    np.testing.assert_array_equal(p, j)
    assert pwav.wav_info(ppath) == jwav.wav_info(ppath)


def test_toy_corpora_are_byte_identical(tmp_path):
    jroot, proot = tmp_path / "j", tmp_path / "p"
    outs = (jtoy.build_corpus(str(jroot), n_utts=3, seed=5),
            ptoy.build_corpus(str(proot), n_utts=3, seed=5))
    jemo = jtoy.build_emotive_corpus(str(jroot / "v"), n_utts=5, seed=2)
    pemo = ptoy.build_emotive_corpus(str(proot / "v"), n_utts=5, seed=2)
    for root_j, root_p in ((jroot, proot), (jroot / "v", proot / "v")):
        names = sorted(os.path.relpath(os.path.join(d, f), root_j)
                       for d, _, fs in os.walk(root_j) for f in fs)
        assert names == sorted(os.path.relpath(os.path.join(d, f), root_p)
                               for d, _, fs in os.walk(root_p) for f in fs)
        for name in names:
            assert filecmp.cmp(root_j / name, root_p / name, shallow=False)
    assert [len(o) for o in outs] == [3, 3]
    assert pemo[1:] != jemo[1:]  # the same layout under another root
    for mode in ("one", "intended", "multi"):
        prows = pfl.load_vesus(pemo[2], pemo[0], use_labels=mode)
        jrows = jfl.load_vesus(pemo[2], pemo[0], use_labels=mode)
        assert [np.asarray(e).tolist() for e in prows[2]] == \
            [np.asarray(e).tolist() for e in jrows[2]]
        assert prows[:2] == jrows[:2]
    assert jfl.load_filepaths_and_text(outs[0][1], "/w/") == \
        pfl.load_filepaths_and_text(outs[0][1], "/w/")


def test_dataset_mels_and_cache_names_match_jax(corpus, tmp_path):
    jd, pd = _datasets(corpus, tmp_path)
    assert len(pd) == len(jd) == 7 and pd.idx == jd.idx
    for (jpath, jids, jspk, jemo), (ppath, pids, pspk, pemo) in zip(
            jd.entries, pd.entries):
        assert ppath == jpath and pspk == jspk
        np.testing.assert_array_equal(pids, jids)
        np.testing.assert_array_equal(pemo, jemo)
        # The same cache file name, so either package reads the other's.
        assert os.path.relpath(pd._mel_path(ppath), tmp_path / "port") == \
            os.path.relpath(jd._mel_path(jpath), tmp_path / "jax")
        j_mel, p_mel = jd.get_mel(jpath), pd.get_mel(ppath)
        assert p_mel.dtype == np.float32 and p_mel.shape == j_mel.shape
        np.testing.assert_allclose(p_mel, j_mel, atol=2e-3)
        assert os.path.exists(pd._mel_path(ppath))
        np.testing.assert_array_equal(pd.get_mel(ppath), p_mel)  # cached
        assert pd.sort_key(0) == jd.sort_key(0)
    # Without a cache directory the .npy goes next to the wav, same name.
    jd.mel_cache_dir = pd.mel_cache_dir = None
    path = jd.entries[0][0]
    assert pd._mel_path(path) == jd._mel_path(path)


def test_collate_and_loader_batches_match_jax(corpus, tmp_path):
    jd, pd = _datasets(corpus, tmp_path, batch_size=2, sort_pool_batches=2)
    jbatches = list(jds.DataLoader(jd, jd.hp, seed=4))
    pbatches = list(pds.PrefetchLoader(pds.DataLoader(pd, pd.hp, seed=4)))
    assert len(pbatches) == len(jbatches) == 3
    for jb, pb in zip(jbatches, pbatches):
        assert pb._fields == jb._fields
        for name in pb._fields:
            if name == "mels":
                np.testing.assert_allclose(pb.mels, jb.mels, atol=2e-3)
            else:
                np.testing.assert_array_equal(getattr(pb, name),
                                              getattr(jb, name))
        assert pb.mels.shape[2] % 20 == 0
    samples = [pd[i] for i in range(3)]
    for jb, pb in ((jds.collate(samples, jd.hp), pds.collate(samples, pd.hp)),
                   (jds.collate(samples, jd.hp, [8], [20]),
                    pds.collate(samples, pd.hp, [8], [20]))):
        for name in pb._fields:
            np.testing.assert_array_equal(getattr(pb, name),
                                          getattr(jb, name))


@pytest.mark.parametrize("K", [1, 3])
def test_collate_pads_to_window_and_frames_per_step(K):
    jhp, hp = _hps(n_frames_per_step=K)
    rng = np.random.RandomState(K)
    samples = [(rng.randint(1, 60, L).astype(np.int32),
                rng.randn(80, M).astype(np.float32), L % 3,
                rng.rand(5).astype(np.float32))
               for L, M in ((9, 33), (40, 95), (4, 1))]
    jb, pb = jds.collate(samples, jhp), pds.collate(samples, hp)
    assert pb.mels.shape[2] % np.lcm(20, K) == 0
    assert pb.mels.shape[2] >= 95 and pb.text.shape[1] >= 40
    for name in pb._fields:
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name))
    assert pds.pick_bucket(33, [16, 32]) == jds.pick_bucket(33, [16, 32])


def test_synthetic_dataset_and_loader_order_match_jax():
    jhp, hp = _hps()
    jd = jds.SyntheticDataset(jhp, size=10, t_in=(5, 30), t_out=(10, 90),
                              seed=2)
    pd = pds.SyntheticDataset(hp, size=10, t_in=(5, 30), t_out=(10, 90),
                              seed=2)
    for jb, pb in zip(jds.DataLoader(jd, jhp, batch_size=3, seed=7),
                      pds.DataLoader(pd, hp, batch_size=3, seed=7)):
        for name in pb._fields:
            np.testing.assert_array_equal(getattr(pb, name),
                                          getattr(jb, name))


def test_prefetch_loader_propagates_errors():
    class Broken:
        def __iter__(self):
            yield 1
            raise ValueError("corrupt sample")

        def __len__(self):
            return 2

    it = iter(pds.PrefetchLoader(Broken()))
    assert next(it) == 1
    with pytest.raises(ValueError, match="corrupt"):
        next(it)


def test_get_mel_from_audio_matches_jax(corpus):
    _, wav_dir, _ = corpus
    path = os.path.join(wav_dir, "u0.wav")
    np.testing.assert_allclose(get_mel_from_audio(path, device="cpu"),
                               np.asarray(jax_get_mel(path)), atol=2e-3)
