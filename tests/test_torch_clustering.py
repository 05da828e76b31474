"""Port parity of the cluster analysis: gantron_tpu_torch's eval/clustering.py
and the ``clustering`` / ``check_kmeans`` CLIs against the JAX package's
eval/clustering.py (which fits ``sklearn.cluster.KMeans``).

The loaders are bit-equal to JAX's when both are given the same mel
function. The port's k-means is held against sklearn's on separable blobs:
the same partition, inertia within 1e-4 relative. sklearn numbers its
clusters by its own draws and the port by first appearance; for the
permutation searches the JAX side's KMeans is renumbered the same way, and
then accuracies and permutations are equal.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import sklearn.cluster

import gantron_tpu.eval.clustering as jcl
from gantron_tpu_torch.audio.mel import MelSpectrogram
from gantron_tpu_torch.cli import check_kmeans as check_kmeans_cli
from gantron_tpu_torch.cli import clustering as clustering_cli
from gantron_tpu_torch.data.toy import synth_emotive_utterance
from gantron_tpu_torch.data.wav import write_wav
from gantron_tpu_torch.eval import clustering as pcl
from torch_threads import one_torch_thread  # noqa: F401


def first_appearance(labels):
    """Cluster ids renumbered in the order the rows first take them."""
    _, first = np.unique(labels, return_index=True)
    order = labels[np.sort(first)]
    new_id = np.empty(order.max() + 1, np.int64)
    new_id[order] = np.arange(len(order))
    return new_id[labels], order


class CanonicalKMeans(sklearn.cluster.KMeans):
    """sklearn's KMeans with the port's numbering of the clusters."""

    def fit(self, X, y=None, sample_weight=None):
        super().fit(X, y, sample_weight)
        self.labels_, order = first_appearance(self.labels_)
        self.cluster_centers_ = self.cluster_centers_[order]
        return self


@pytest.fixture
def canonical_sklearn(monkeypatch):
    monkeypatch.setattr(sklearn.cluster, "KMeans", CanonicalKMeans)


def blobs(k, per, dim, seed, spread=0.3):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, dim) * 3
    x = np.concatenate([c + rng.randn(per, dim) * spread for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(k), per)


def write_group_mels(root, n_groups=2, per=10, seed=0):
    rng = np.random.RandomState(seed)
    for g in range(n_groups):
        for i in range(per):
            mel = rng.randn(8, 12 + i).astype(np.float32) * 2 - 40 + g * 14
            np.save(os.path.join(root, f"{g}-{i}.npy"), mel)


def write_tone_wavs(root, names, emotions, seed=0):
    rng = np.random.RandomState(seed)
    for name, emotion in zip(names, emotions):
        write_wav(os.path.join(root, name),
                  synth_emotive_utterance("ames", emotion, 0, rng))


@pytest.fixture(scope="module")
def mel_fn():
    return MelSpectrogram(filter_length=256, hop_length=64, win_length=256,
                          n_mel_channels=16, device="cpu")


def test_load_mels_matches_jax(tmp_path, mel_fn):
    write_group_mels(str(tmp_path))
    (tmp_path / "notes.txt").write_text("not a mel")
    want, got = jcl.load_mels(str(tmp_path)), pcl.load_mels(str(tmp_path))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2] == [0] * 10 + [1] * 10
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    write_tone_wavs(str(wavs), ["0-0.wav", "0-1.wav", "1-0.wav"],
                    ["Neutral", "Neutral", "Angry"])
    want = jcl.load_mels(str(wavs), from_audio=True, mel_fn=mel_fn)
    got = pcl.load_mels(str(wavs), from_audio=True, mel_fn=mel_fn)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    # The port reads the classes of wav names too; the JAX package only of
    # .npy names.
    assert want[2] == [] and got[2] == [0, 0, 1]


def test_load_mels_by_emotion_dir_matches_jax(tmp_path, mel_fn):
    for emotion in ("calm", "tense"):
        d = tmp_path / "a" / emotion
        d.mkdir(parents=True)
        write_tone_wavs(str(d), ["0.wav", "1.wav"],
                        ["Sad" if emotion == "calm" else "Angry"] * 2,
                        seed=len(emotion))
        np.save(str(d / "2.npy"), np.full((16, 30), -3.0, np.float32))
    (tmp_path / "a" / "list.txt").write_text("")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    want = jcl.load_mels_by_emotion_dir(str(tmp_path / "a"), mel_fn=mel_fn)
    got = pcl.load_mels_by_emotion_dir(str(tmp_path / "b"), mel_fn=mel_fn)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == ["calm", "tense"]
    np.testing.assert_array_equal(np.load(tmp_path / "b" / "calm" / "0.npy"),
                                  np.load(tmp_path / "a" / "calm" / "0.npy"))


@pytest.mark.parametrize("k,per,dim", [(3, 20, 16), (5, 12, 40)])
def test_kmeans_matches_sklearn(k, per, dim):
    x, _ = blobs(k, per, dim, seed=k)
    ref = sklearn.cluster.KMeans(n_clusters=k, random_state=0,
                                 n_init=10).fit(x)
    got = pcl.kmeans(x, k, n_init=10, seed=0, device="cpu")
    want, order = first_appearance(ref.labels_)
    np.testing.assert_array_equal(got.labels_, want)
    np.testing.assert_allclose(got.inertia_, ref.inertia_, rtol=1e-4)
    np.testing.assert_allclose(got.cluster_centers_,
                               ref.cluster_centers_[order], atol=1e-5)
    again = pcl.kmeans(x, k, n_init=10, seed=0, device="cpu")
    np.testing.assert_array_equal(again.labels_, got.labels_)
    with pytest.raises(ValueError):
        pcl.kmeans(x, 0, device="cpu")


def test_check_clusterization_matches_jax(tmp_path, canonical_sklearn):
    write_group_mels(str(tmp_path), n_groups=3, per=6)
    mels, _, classes = pcl.load_mels(str(tmp_path))
    acc, perm, km = pcl.check_clusterization(mels, classes, classes_items=6,
                                             n_init=5, device="cpu")
    j_acc, j_perm, j_km = jcl.check_clusterization(mels, classes,
                                                   classes_items=6, n_init=5)
    assert acc == j_acc == 1.0 and perm == j_perm
    np.testing.assert_array_equal(km.labels_, j_km.labels_)


@pytest.mark.parametrize("k,n_clusters", [(3, None), (12, None), (4, 4)])
def test_check_kmeans_accuracy_matches_jax(k, n_clusters, canonical_sklearn):
    x, ids = blobs(k, 8, 6, seed=k + 1, spread=0.05)
    got = pcl.check_kmeans_accuracy(x, ids, n_clusters, n_init=5,
                                    device="cpu")
    want = jcl.check_kmeans_accuracy(x, ids, n_clusters, n_init=5)
    assert got == want
    with pytest.raises(ValueError, match="n_clusters"):
        pcl.check_kmeans_accuracy(x, ids, k - 1, device="cpu")


def test_run_clustering_matches_jax_and_names_missing_packages(
        monkeypatch, canonical_sklearn, tmp_path):
    x, _ = blobs(3, 6, 10, seed=7)
    labels, centers, emb = pcl.run_clustering(x, 3, n_init=5,
                                              with_tsne=False, device="cpu")
    j_labels, j_centers, j_emb = jcl.run_clustering(x, 3, n_init=5,
                                                    with_tsne=False)
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_allclose(centers, j_centers, atol=1e-5)
    assert emb is None and j_emb is None
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    with pytest.raises(ImportError, match="sklearn"):
        pcl.run_clustering(x, 3, n_init=1, device="cpu")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        pcl.save_tsne_plot(np.zeros((18, 2)), labels,
                           str(tmp_path / "t.jpg"))


def test_check_kmeans_cli(tmp_path):
    for emotion in ("Neutral", "Angry", "Sad"):
        d = tmp_path / emotion
        d.mkdir()
        write_tone_wavs(str(d), [f"{i}.wav" for i in range(4)],
                        [emotion] * 4, seed=len(emotion))
    basic, best, perm = check_kmeans_cli.main(
        ["--audio_path", str(tmp_path), "--device", "cpu"])
    assert best == 1.0 and sorted(perm) == [0, 1, 2]
    assert (tmp_path / "Sad" / "3.npy").exists()


def test_clustering_cli(tmp_path):
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    names = [f"{g}-{i}.wav" for g in range(2) for i in range(4)]
    write_tone_wavs(str(wavs), names, ["Sad"] * 4 + ["Angry"] * 4)
    acc, classes, km = clustering_cli.main(
        ["--path", str(wavs), "--audio", "--check_clusterizations",
         "--classes_items", "4", "--device", "cpu"])
    assert acc == 1.0 and len(km.labels_) == 8
    # Five mels or fewer take no t-SNE embedding (as in the JAX package).
    mels = tmp_path / "mels"
    mels.mkdir()
    write_group_mels(str(mels), n_groups=1, per=5)
    labels, centers, emb = clustering_cli.main(
        ["--path", str(mels), "--clusters", "2", "--n_mel_channels", "8",
         "--device", "cpu"])
    assert len(labels) == 5 and centers.shape == (2, 8 * 12)
    assert emb is None and not (mels / "tsne.jpg").exists()
