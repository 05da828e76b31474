"""K-means / t-SNE cluster analysis of generated mels (port of
gantron_tpu/eval/clustering.py; reference: clustering.py, check_kmeans.py).

``load_mels`` flattens fixed-length mel prefixes normalized by the global
max; ``check_clusterization`` searches the cluster->class permutations to
score how separable the generation groups are; ``check_kmeans_accuracy``
scores a corpus laid out one directory per emotion with the Hungarian
assignment; ``run_clustering`` returns k-means labels and centroids, plus a
2-D t-SNE embedding for plotting.

K-means is written here in PyTorch and runs on ``device``: k-means++
seeding (sklearn's greedy variant, 2 + log k candidates a centre), Lloyd
iterations until no centre moves more than ``tol`` (relative to the mean
feature variance, as sklearn's), ``n_init`` restarts, the lowest inertia
kept. It computes the function ``sklearn.cluster.KMeans`` computes. Its
draws come from a CPU generator seeded with ``seed``, so the card and the
CPU seed alike, and its cluster ids are numbered in the order in which the
rows first take them. sklearn (t-SNE) and matplotlib (the plot) are
imported inside the functions that need them.
"""

import itertools
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from gantron_tpu_torch.utils.device import resolve_device


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _mel_of_wav(path, mel_fn):
    from gantron_tpu_torch.data.wav import load_wav

    return _numpy(mel_fn(load_wav(path)[None]))[0]


def _flatten(full_mels, min_len, max_val):
    return np.stack([m[:, :min_len].flatten() / max_val for m in full_mels])


def load_mels(base_path, n_mel_channels=80, from_audio=False, mel_fn=None):
    """Load .npy mels (or, with ``from_audio``, .wav files through
    ``mel_fn``); returns (flattened matrix (N, n_mel*min_len), max_val,
    classes). A file named 'g-...' is of class g: .npy as in the JAX
    package, and .wav too (there a wav folder has no classes, so its
    ``check_clusterization`` cannot run)."""
    full_mels, classes = [], []
    min_len = float("inf")
    max_val = 0.0
    for path in sorted(os.listdir(base_path)):
        full = os.path.join(base_path, path)
        if from_audio and path.endswith(".wav"):
            mel = _mel_of_wav(full, mel_fn)
        elif path.endswith(".npy"):
            mel = np.load(full, allow_pickle=True)
        else:
            continue
        if "-" in path:
            classes.append(int(path.split("-")[0]))
        if mel.ndim == 3:
            mel = mel[0]
        min_len = min(min_len, mel.shape[1])
        max_val = max(max_val, abs(float(mel.min())), abs(float(mel.max())))
        full_mels.append(mel)

    if not full_mels:
        return np.zeros((0, 0)), 0.0, []
    mels = _flatten(full_mels, int(min_len), max_val)
    if classes:
        assert len(classes) == len(full_mels)
    return mels, max_val, classes


def load_mels_by_emotion_dir(base_path, mel_fn=None):
    """Reference check_kmeans.py:12-50 loader: each subdirectory of
    ``base_path`` is an emotion class containing .wav (mel extracted through
    ``mel_fn`` and cached to .npy beside it) or pre-dumped .npy mels.
    Returns (flattened matrix (N, n_mel*min_len), class-id array, class
    names)."""
    full_mels, class_ids, names = [], [], []
    min_len = float("inf")
    max_val = 0.0
    for emotion in sorted(os.listdir(base_path)):
        em_dir = os.path.join(base_path, emotion)
        if "." in emotion or not os.path.isdir(em_dir):
            continue
        names.append(emotion)
        for path in sorted(os.listdir(em_dir)):
            full = os.path.join(em_dir, path)
            stem, ext = os.path.splitext(full)
            if ext == ".npy":
                mel = np.load(full, allow_pickle=True)
            elif ext == ".wav" and not os.path.exists(stem + ".npy"):
                mel = _mel_of_wav(full, mel_fn)
                try:
                    np.save(stem + ".npy", mel)
                except OSError:
                    pass
            else:
                continue
            if mel.ndim == 3:
                mel = mel[0]
            min_len = min(min_len, mel.shape[1])
            max_val = max(max_val, abs(float(mel.min())),
                          abs(float(mel.max())))
            full_mels.append(mel)
            class_ids.append(len(names) - 1)
    if not full_mels:
        return np.zeros((0, 0)), np.zeros((0,), int), names
    mels = _flatten(full_mels, int(min_len), max_val)
    return mels, np.asarray(class_ids), names


# sklearn's defaults: Lloyd iterations a run, and the convergence bound on
# the centres' total squared shift, as a share of the mean feature variance.
MAX_ITER, TOL = 300, 1e-4


class KMeansResult(NamedTuple):
    """sklearn's fitted attributes, as numpy: ``labels_`` (N,),
    ``cluster_centers_`` (k, D) and ``inertia_`` of the kept run."""

    labels_: np.ndarray
    cluster_centers_: np.ndarray
    inertia_: float


def _sq_dists(x, c, x_sq):
    """(N, k) squared distances, clipped at 0."""
    return torch.clamp(x_sq[:, None] - 2.0 * (x @ c.T)
                       + (c * c).sum(1)[None, :], min=0.0)


def _kmeans_pp(x, x_sq, k, gen):
    """sklearn's greedy k-means++: the first centre uniform, each next one
    the best of 2 + log k candidates drawn in proportion to the squared
    distance to the nearest centre so far."""
    n = x.shape[0]
    trials = 2 + int(math.log(k))
    first = int(torch.randint(0, n, (1,), generator=gen))
    centers = [first]
    closest = _sq_dists(x, x[first:first + 1], x_sq)[:, 0]
    pot = closest.sum()
    for _ in range(1, k):
        draws = torch.rand(trials, generator=gen, dtype=torch.float64)
        cand = torch.searchsorted(torch.cumsum(closest, 0),
                                  draws.to(x.device) * pot)
        cand = torch.clamp(cand, max=n - 1)
        d = torch.minimum(closest[None, :], _sq_dists(x, x[cand], x_sq).T)
        pots = d.sum(1)
        best = int(torch.argmin(pots))
        centers.append(int(cand[best]))
        closest, pot = d[best], pots[best]
    return x[centers].clone()


def _lloyd(x, x_sq, centers, tol):
    """Lloyd iterations to convergence: (labels, centers, inertia). A
    cluster left empty takes the row farthest from its centre."""
    k = centers.shape[0]
    for _ in range(MAX_ITER):
        d = _sq_dists(x, centers, x_sq)
        labels = d.argmin(1)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        counts = onehot.sum(0)
        sums = onehot.T @ x  # a product, not atomics: the same every run
        new = sums / torch.clamp(counts, min=1)[:, None]
        empty = torch.nonzero(counts == 0).flatten().tolist()
        if empty:
            far = d.gather(1, labels[:, None])[:, 0].argsort(descending=True)
            for j, row in zip(empty, far.tolist()):
                new[j] = x[row]
        shift = ((new - centers) ** 2).sum()
        centers = new
        if float(shift) <= tol:
            break
    d = _sq_dists(x, centers, x_sq)
    labels = d.argmin(1)
    inertia = d.gather(1, labels[:, None]).sum()
    return labels, centers, float(inertia)


def kmeans(data, n_clusters, n_init=10, seed=0,
           device="cuda") -> KMeansResult:
    """K-means of the rows of ``data`` (N, D) on ``device`` in float64: the
    best of ``n_init`` k-means++ / Lloyd runs by inertia, its cluster ids
    renumbered in order of first appearance."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(data), dtype=torch.float64, device=device)
    if not 0 < n_clusters <= x.shape[0]:
        raise ValueError(f"n_clusters={n_clusters} must be in "
                         f"[1, {x.shape[0]}] (the number of rows)")
    x_sq = (x * x).sum(1)
    tol = TOL * float(x.var(0, correction=0).mean())
    gen = torch.Generator().manual_seed(int(seed))
    best = None
    for _ in range(n_init):
        run = _lloyd(x, x_sq, _kmeans_pp(x, x_sq, n_clusters, gen), tol)
        if best is None or run[2] < best[2]:
            best = run
    labels, centers, inertia = best
    labels = labels.cpu().numpy()
    _, first = np.unique(labels, return_index=True)
    order = labels[np.sort(first)]  # old ids by first appearance
    order = np.concatenate([order, np.setdiff1d(np.arange(n_clusters),
                                                order)])
    new_id = np.empty(n_clusters, np.int64)
    new_id[order] = np.arange(n_clusters)
    return KMeansResult(new_id[labels].astype(np.int32),
                        centers.cpu().numpy()[order], inertia)


def check_clusterization(mels, classes, classes_items=20, n_init=30,
                         seed=0, device="cuda"):
    """Fit k-means with k = #unique classes and search all label
    permutations for the best accuracy (reference check_kmeans logic inside
    clustering.py:67-88): the files are taken as sorted by class,
    ``classes_items`` a class."""
    unique = np.unique(np.asarray(classes))
    km = kmeans(mels, len(unique), n_init=n_init, seed=seed, device=device)
    y = km.labels_
    best_acc, best_classes = 0.0, None
    for perm in itertools.permutations(unique):
        new_classes = [c for c in perm for _ in range(classes_items)]
        acc = float(np.sum(y == np.asarray(new_classes[: len(y)])) / len(y))
        if acc > best_acc:
            best_acc, best_classes = acc, perm
    return best_acc, best_classes, km


def run_clustering(mels, n_clusters=6, n_init=20, seed=0, with_tsne=True,
                   device="cuda"):
    """K-means labels + centroids (+ a t-SNE 2-D embedding, which needs
    sklearn)."""
    km = kmeans(mels, n_clusters, n_init=n_init, seed=seed, device=device)
    embedded = None
    if with_tsne and len(mels) > 5:
        try:
            from sklearn.manifold import TSNE
        except ImportError as e:
            raise ImportError("the t-SNE embedding needs scikit-learn "
                              "(sklearn), which is not installed") from e

        embedded = TSNE(perplexity=min(30, max(5, len(mels) // 4))
                        ).fit_transform(mels)
    return km.labels_, km.cluster_centers_, embedded


def save_tsne_plot(embedded, labels, save_path, n_clusters=6):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the t-SNE plot needs matplotlib, which is not "
                          "installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    scatter = ax.scatter(embedded[:, 0], embedded[:, 1], c=labels,
                         cmap="tab10", s=12)
    fig.colorbar(scatter, ax=ax)
    fig.savefig(save_path, dpi=300)
    plt.close(fig)


def check_kmeans_accuracy(mels, class_ids, n_clusters=None, n_init=30,
                          seed=0, device="cuda"):
    """Reference check_kmeans.py:60-75: k-means fit, then the basic accuracy
    and the best accuracy over all cluster->class label permutations,
    found by the Hungarian assignment on the (class, cluster) confusion
    matrix (scipy's ``linear_sum_assignment``)."""
    from scipy.optimize import linear_sum_assignment

    unique = np.unique(class_ids)
    k = n_clusters or len(unique)
    if k < len(unique):
        raise ValueError(
            f"n_clusters={k} < {len(unique)} distinct classes: the "
            "cluster->class permutation search cannot map every class")
    y = kmeans(mels, k, n_init=n_init, seed=seed, device=device).labels_
    basic_acc = float(np.mean(y == class_ids))
    conf = np.zeros((k, k))
    for cls, clu in zip(class_ids, y):
        conf[cls, clu] += 1
    rows, cols = linear_sum_assignment(-conf)
    best_perm = tuple(int(c) for c in cols)
    best_acc = float(conf[rows, cols].sum() / len(y))
    return basic_acc, best_acc, best_perm
