"""Text+mel dataset with bucketed batching (port of
gantron_tpu/data/dataset.py).

Replaces the reference TextMelLoader/TextMelCollate (data_utils.py:13-131):

  * text -> symbol ids at construction (cheap, cached);
  * mel extraction through ``MelSpectrogram`` on ``device`` (the card by
    default, where it is one launch of the mel kernel, csrc/mel.cu), cached
    to .npy under the same names as the JAX package's cache, so a cache
    written by either package reads in the other; or loaded from disk
    (``load_mel_from_disk``);
  * batches are padded up to (text_bucket, mel_bucket) boundaries instead of
    the per-batch max, as the JAX package pads them for its compiled train
    step. Mel buckets are rounded up to discriminator-window multiples.
  * no per-batch length-sorting (needed only for torch's
    pack_padded_sequence; the masked BiLSTM handles arbitrary order), but
    POOLED length-aware batching: similar-length samples batch together so
    each batch collates to its own bucket (see DataLoader).

Gate targets are 1 from each sample's last valid frame onward
(reference data_utils.py:127).
"""

import os
import random
from typing import Iterator, List, Optional, Sequence

import numpy as np

from gantron_tpu_torch.audio import MelSpectrogram
from gantron_tpu_torch.data.filelists import (load_filepaths_and_text,
                                              load_vesus)
from gantron_tpu_torch.data.wav import load_wav, wav_info
from gantron_tpu_torch.text import text_to_sequence
from gantron_tpu_torch.train.step import Batch


def pick_bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


class TextMelDataset:
    """Featurizes on ``device``: the card unless ``device="cpu"`` is passed.
    The JAX package keeps this work on the host CPU so that it does not
    occupy the TPU; on the H100 the fused mel kernel is the point. Either way
    ``get_mel`` returns numpy, as the JAX dataset does."""

    def __init__(self, audiopaths_and_text_files, hp, wavs_path,
                 mel_cache_dir: Optional[str] = None, device="cuda"):
        self.hp = hp
        self.entries = []  # (audiopath, text_ids, speaker, emotions)

        lj = load_filepaths_and_text(audiopaths_and_text_files[0], wavs_path)
        # LJ rows get speaker 0 and zero emotions (reference
        # data_utils.py:26-30).
        rows = [(r[0], r[1], 0, [0.0] * 5) for r in lj]

        if hp.vesus_path:
            mode = "intended" if hp.use_intended_labels else "multi"
            v_paths, v_speakers, v_emotions = load_vesus(
                audiopaths_and_text_files[1], hp.vesus_path, use_labels=mode)
            rows += [(p, t, s, list(e)) for (p, t), s, e in
                     zip(v_paths, v_speakers, v_emotions)]

        for path, text, speaker, emotions in rows:
            ids = np.asarray(text_to_sequence(text, hp.text_cleaners),
                             np.int32)
            self.entries.append((path, ids, speaker,
                                 np.asarray(emotions, np.float32)))

        self.mel_fn = MelSpectrogram(
            hp.filter_length, hp.hop_length, hp.win_length, hp.n_mel_channels,
            hp.sampling_rate, hp.mel_fmin, hp.mel_fmax, device=device)
        self.mel_cache_dir = mel_cache_dir
        self.load_mel_from_disk = hp.load_mel_from_disk
        # Cache key: mel-affecting hparams fingerprint, so changing the STFT
        # or mel config can never silently reuse stale cached features.
        import hashlib

        cfg = (f"{hp.sampling_rate}-{hp.filter_length}-{hp.hop_length}-"
               f"{hp.win_length}-{hp.n_mel_channels}-{hp.mel_fmin}-"
               f"{hp.mel_fmax}")
        self._mel_tag = hashlib.md5(cfg.encode()).hexdigest()[:8]

        # Deterministic shuffled index indirection (reference
        # data_utils.py:36-42).
        self.idx = list(range(len(self.entries)))
        rng = random.Random(hp.seed)
        rng.shuffle(self.idx)

    def __len__(self):
        return len(self.entries)

    def _mel_path(self, audiopath: str) -> str:
        base = os.path.splitext(audiopath)[0]
        if self.mel_cache_dir:
            # Basenames repeat across corpus subdirs (VESUS lays out
            # Audio/<emotion>/<speaker>/1.wav); key by the full path too or
            # same-named wavs silently share one cache file.
            import hashlib

            h = hashlib.md5(
                os.path.abspath(audiopath).encode()).hexdigest()[:10]
            return os.path.join(
                self.mel_cache_dir,
                f"{os.path.basename(base)}.{h}.{self._mel_tag}.mel.npy")
        return f"{base}.{self._mel_tag}.mel.npy"

    def get_mel(self, audiopath: str) -> np.ndarray:
        """(n_mel, T) float32."""
        if self.load_mel_from_disk:
            mel = np.load(audiopath, allow_pickle=True)
            assert mel.shape[0] == self.hp.n_mel_channels
            return mel.astype(np.float32)
        cache = self._mel_path(audiopath)
        if os.path.exists(cache):
            return np.load(cache)
        wav = load_wav(audiopath, self.hp.sampling_rate)
        mel = self._wav_to_mel(wav)
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.save(cache, mel)
        except OSError:
            pass  # read-only dataset dir: recompute next epoch
        return mel

    def _wav_to_mel(self, wav: np.ndarray) -> np.ndarray:
        """(n_mel, T) float32 of the wav at its true length.

        The JAX package pads each wav to a length bucket to bound its XLA
        compiles (its frames are the true ones, sliced back); PyTorch runs
        eagerly, so the port featurizes the true length, with the same
        frames. On the card this is one kernel launch on the calling
        thread's current stream, and the ``.cpu()`` copy waits for it (a
        ``PrefetchLoader`` thread included)."""
        return self.mel_fn(wav[None])[0].cpu().numpy()

    def __getitem__(self, index: int):
        path, ids, speaker, emotions = self.entries[self.idx[index]]
        return ids, self.get_mel(path), speaker, emotions

    def sort_key(self, index: int) -> int:
        """Approximate mel frame count WITHOUT decoding audio (RIFF header
        only, memoized) — feeds length-aware batch pooling."""
        if not hasattr(self, "_sort_keys"):
            self._sort_keys = {}
        key = self._sort_keys.get(index)
        if key is None:
            path = self.entries[self.idx[index]][0]
            if self.load_mel_from_disk:
                key = index  # mel files: length unknown cheaply; stable order
            else:
                try:
                    num_samples, rate = wav_info(path)
                    scaled = num_samples * self.hp.sampling_rate / max(rate, 1)
                    key = int(scaled // self.hp.hop_length) + 1
                except Exception:
                    # Sorting is an optimization; a malformed header must
                    # degrade to key 0, never kill the training iterator
                    # (struct.error is not a ValueError).
                    key = 0
            self._sort_keys[index] = key
        return key


def collate(samples, hp, text_buckets=None, mel_buckets=None) -> Batch:
    """Pad a list of (text_ids, mel, speaker, emotions) to bucket shapes."""
    text_buckets = text_buckets or hp.text_buckets
    mel_buckets = mel_buckets or hp.mel_buckets
    import math

    # T_out must be a multiple of BOTH the GAN window and n_frames_per_step.
    W = math.lcm(hp.discriminator_window, max(hp.n_frames_per_step, 1))

    B = len(samples)
    max_t = max(len(s[0]) for s in samples)
    max_m = max(s[1].shape[1] for s in samples)
    T_in = pick_bucket(max_t, text_buckets)
    T_out = pick_bucket(max_m, mel_buckets)
    T_out = ((T_out + W - 1) // W) * W  # window multiple for the GAN
    # Never truncate: grow past the last bucket if a sample exceeds it.
    T_in = max(T_in, max_t)
    T_out = max(((max_m + W - 1) // W) * W, T_out)

    text = np.zeros((B, T_in), np.int32)
    text_lengths = np.zeros((B,), np.int32)
    mels = np.zeros((B, hp.n_mel_channels, T_out), np.float32)
    gate = np.zeros((B, T_out), np.float32)
    speaker = np.zeros((B,), np.int32)
    emotions = np.zeros((B, 5), np.float32)
    output_lengths = np.zeros((B,), np.int32)

    for i, (ids, mel, spk, emo) in enumerate(samples):
        L, M = len(ids), mel.shape[1]
        text[i, :L] = ids
        text_lengths[i] = L
        mels[i, :, :M] = mel
        gate[i, M - 1 :] = 1.0
        speaker[i] = spk
        emotions[i] = emo
        output_lengths[i] = M

    return Batch(text=text, text_lengths=text_lengths, mels=mels, gate=gate,
                 speaker=speaker, emotions=emotions,
                 output_lengths=output_lengths)


class DataLoader:
    """Sequential batcher over the shuffled dataset (drop_last like the
    reference train loader, train.py:107-110).

    Length-aware pooling: the shuffled order is chopped into pools of
    ``sort_pool_batches`` batches, each pool is sorted by (cheap,
    header-derived) mel length, and the pool's batches are emitted in
    shuffled order. Similar-length samples land in the same batch — so
    batches collate to their *own* bucket instead of one long sample
    dragging a whole batch to the top mel bucket — while the pool-level
    shuffle keeps batch composition stochastic across epochs. The reference
    only sorts within a batch (for pack_padded_sequence,
    data_utils.py:88-99), which does not reduce padding at all."""

    def __init__(self, dataset: TextMelDataset, hp, batch_size=None,
                 shuffle=True, drop_last=True, seed=None):
        self.dataset = dataset
        self.hp = hp
        self.batch_size = batch_size or hp.batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = hp.seed if seed is None else seed
        self.sort_pool = max(int(getattr(hp, "sort_pool_batches", 8)), 1)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _sort_key(self, i: int) -> int:
        ds = self.dataset
        if hasattr(ds, "sort_key"):
            return ds.sort_key(i)
        return ds[i][1].shape[1]  # in-memory datasets: true mel length

    def __iter__(self) -> Iterator[Batch]:
        order = list(range(len(self.dataset)))
        rng = random.Random(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(order)
        self.epoch += 1

        B = self.batch_size
        pool_size = B * self.sort_pool
        batches: List[List[int]] = []
        for start in range(0, len(order), pool_size):
            pool = order[start : start + pool_size]
            if self.shuffle and self.sort_pool > 1:
                pool.sort(key=self._sort_key)
            pool_batches = [pool[i : i + B] for i in range(0, len(pool), B)]
            if self.shuffle:
                rng.shuffle(pool_batches)
            batches.extend(pool_batches)

        for idxs in batches:
            if len(idxs) == B or not self.drop_last:
                yield collate([self.dataset[i] for i in idxs], self.hp)


class PrefetchLoader:
    """Background-thread prefetch over any batch iterable: overlaps host-side
    loading/collation with device compute (the reference relies on torch
    DataLoader workers, train.py:107; here one thread + a small queue is
    enough because mels are cached after the first epoch)."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        _END = object()
        _ERROR = object()
        stop = threading.Event()

        def put(item):
            # Bounded put that gives up when the consumer abandoned the
            # iterator (early `return` from a training loop): a plain
            # q.put would block this thread forever, pinning its batches.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.loader:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised below
                # Propagate to the consumer: swallowing here would turn a
                # corrupt sample into a silently-truncated epoch.
                put((_ERROR, e))
            else:
                put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] is _ERROR:
                    raise item[1]
                yield item
        finally:
            stop.set()


class SyntheticDataset:
    """Deterministic synthetic samples with realistic length distribution —
    used by benchmarks and smoke tests when no corpus is mounted."""

    def __init__(self, hp, size=256, t_in=(40, 180), t_out=(180, 860),
                 seed=0):
        self.hp = hp
        self.size = size
        rng = np.random.RandomState(seed)
        self.samples = []
        for _ in range(size):
            L = int(rng.randint(*t_in))
            M = int(rng.randint(*t_out))
            ids = rng.randint(1, hp.n_symbols, L).astype(np.int32)
            mel = (rng.randn(hp.n_mel_channels, M) * 1.5 - 6.0).astype(
                np.float32)
            self.samples.append(
                (ids, mel, 0, rng.rand(5).astype(np.float32)))
        self.idx = list(range(size))

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        return self.samples[self.idx[index]]
