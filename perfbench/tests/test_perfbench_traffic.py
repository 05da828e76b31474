"""The traffic generators: deterministic for a seed, different across
seeds, the length rule followed, the data files as the filelists have
them."""

import numpy as np
import pytest

from perfbench.tests.tiny import cells, load
from perfbench.traffic import synth_batch, train_cycle

SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("cell", cells("synth_batch"))
def test_synthesis_batches_follow_the_seed_and_the_length_rule(cell):
    c = load("workloads", cell)
    cfg = load("configs", c["config"])
    p, m = c["params"], cfg["model"]
    corpus = synth_batch.load_corpus(p["corpus"])

    def stream(seed, n=5):
        b = synth_batch.Batches(corpus, p, seed)
        return [[r["text"] for r in b.next_rows()] for _ in range(n)]

    assert stream(SEED) == stream(SEED)
    assert stream(SEED) != stream(SEED + 1)
    rows = synth_batch.Batches(corpus, p, SEED).next_rows()
    ids, lengths, frames, speaker, emotions = synth_batch.batch_inputs(
        rows, p, m)
    assert ids.shape == (p["batch"], lengths.max())
    for b, r in enumerate(rows):
        assert list(ids[b, :lengths[b]]) == r["ids"]
        assert not ids[b, lengths[b]:].any()
        assert frames[b] == min(p["max_frames"],
                                round(p["frames_per_char"] * len(r["ids"])))
    assert (speaker is None) == (not m["vesus"])
    if m["vesus"]:
        assert emotions.shape == (p["batch"], m["n_labels"])


def test_a_pass_over_the_corpus_takes_every_row_once():
    c = load("workloads", cells("synth_batch")[0])
    p = dict(c["params"], batch=1000)
    corpus = [{"text": str(i), "ids": [1]} for i in range(2500)]
    b = synth_batch.Batches(corpus, p, SEED)
    seen = [r["text"] for _ in range(5) for r in b.next_rows()]
    assert sorted(seen[:2500]) == sorted(str(i) for i in range(2500))
    assert sorted(seen[2500:]) == sorted(str(i) for i in range(2500))


@pytest.mark.parametrize("corpus,n,lo,hi", [("vesus", 12343, 3, 38),
                                            ("ljspeech", 12750, 12, 188)])
def test_the_data_files_hold_the_filelists_rows(corpus, n, lo, hi):
    rows = synth_batch.load_corpus(corpus)
    lengths = [len(r["ids"]) for r in rows]
    assert len(rows) == n and min(lengths) == lo and max(lengths) == hi
    assert all(0 < i < 148 for r in rows for i in r["ids"])


def test_the_draws_follow_the_seed():
    import torch

    cfg = load("configs", "gantron-ljspeech")
    a = synth_batch.draws(cfg, SEED, 3, 2, 5, torch.device("cpu"))
    b = synth_batch.draws(cfg, SEED, 3, 2, 5, torch.device("cpu"))
    c = synth_batch.draws(cfg, SEED, 4, 2, 5, torch.device("cpu"))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert [z.shape for z in a[1]] == [(2, 160, 4), (2, 160, 2),
                                       (2, 160, 2)]


def test_training_batches_are_benchs_and_follow_the_seed():
    m = load("configs", "gantron-ljspeech")["model"]
    a = train_cycle.make_batch(m, 7, 6, 16, 32)
    b = train_cycle.make_batch(m, 7, 6, 16, 32)
    c = train_cycle.make_batch(m, 8, 6, 16, 32)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[2], c[2])
    text, tl, mels, gate, ol = a
    assert tl[0] == 16 and ol[0] == 32 and text.min() >= 1
    for r in range(6):
        assert not mels[r, :, ol[r]:].any()
        assert gate[r, ol[r] - 1:].all() and not gate[r, :ol[r] - 1].any()
    # cli/bench.py's own batch, draw for draw.
    from gantron_tpu_torch.cli.bench import make_batch
    from gantron_tpu_torch.config import HParams

    bench = make_batch(HParams.create("use_labels=False,use_noise=True"),
                       seed=7, B=6, T_in=16, T_out=32)
    assert np.array_equal(bench.text, text)
    assert np.array_equal(bench.mels, mels)
    assert np.array_equal(bench.output_lengths, ol)
