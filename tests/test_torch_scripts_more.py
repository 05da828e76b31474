"""The last scripts of the port and its inference notebook, on the CPU at
tiny widths: the five ``ablate_*`` timing functions (one or two steps,
their printed lines), ``alignment_demo`` (its checkpoints, and the
validation alignments as ``.npy`` where matplotlib is missing),
``profile_decode_split``'s function (its fields) and
``gantron_tpu_torch/notebooks/inference.ipynb``'s code cells run in order
on a checkpoint written here.
"""

import json
import os
import re

import numpy as np
import pytest

import torch

from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.models.waveglow import WaveGlowConfig
from gantron_tpu_torch.scripts import (ablate_batch, ablate_deferred,
                                       ablate_deferred2, ablate_dw,
                                       ablate_unroll, alignment_demo,
                                       profile_decode_split)
from gantron_tpu_torch.train.checkpoint import CheckpointManager
from gantron_tpu_torch.train.state import create_train_state
from gantron_tpu_torch.cli.bench import make_batch
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOK = os.path.join(REPO, "gantron_tpu_torch", "notebooks",
                        "inference.ipynb")
# test_train_step.tiny_hp's widths.
TINY = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
            encoder_n_convolutions=2, attention_rnn_dim=48,
            decoder_rnn_dim=48, prenet_dim=16, attention_dim=24,
            attention_location_n_filters=4,
            attention_location_kernel_size=7, postnet_embedding_dim=32,
            postnet_n_convolutions=3, noise_size=8, discriminator_dim=32,
            max_decoder_steps=24)
SHORT = dict(B=2, T_in=12, T_out=24, warmup=1, iters=1, hp_over=TINY)
MS = r"\s+\d+\.\d ms"


def lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_ablate_deferred_prints_both_flags_and_the_speedup(capsys):
    out = ablate_deferred.run("cpu", **SHORT)
    assert set(out) == {True, False}
    got = lines(capsys)
    assert got[0] == "device cpu"
    assert re.fullmatch(r"g_step deferred_dw=True  " + MS
                        + r"  loss -?\d+\.\d{4}", got[1]), got[1]
    assert re.fullmatch(r"g_step deferred_dw=False " + MS
                        + r"  loss -?\d+\.\d{4}", got[2]), got[2]
    assert re.fullmatch(r"speedup \d+\.\d{3}x", got[3]), got[3]
    assert all(np.isfinite(t) and t > 0 for t, _ in out.values())


def test_ablate_deferred2_sweeps_unroll_and_frames(capsys):
    out = ablate_deferred2.run("cpu", unrolls=(4, 8), frames=(2,), **SHORT)
    got = lines(capsys)
    assert got[1] == ablate_deferred2.UNROLL_IGNORED
    assert re.fullmatch(r"unroll=4   K=1  g_step" + MS, got[2]), got[2]
    assert re.fullmatch(r"unroll=8   K=1  g_step" + MS, got[3]), got[3]
    assert re.fullmatch(r"unroll=8   K=2  g_step" + MS, got[4]), got[4]
    assert list(out) == ["unroll=4 K=1", "unroll=8 K=1", "unroll=8 K=2"]


def test_ablate_dw_times_the_three_passes(capsys):
    out = ablate_dw.run("cpu", **SHORT)
    assert set(out) == {"fwd", "grad_full", "grad_no_scanW"}
    got = lines(capsys)
    for line, name in zip(got[1:4], ("fwd", "grad_full", "grad_no_scanW")):
        assert re.fullmatch(rf"{name}\s+-?\d+\.\d ms", line), line
    assert re.fullmatch(r"in-scan dW accumulation cost ~=\s+-?\d+\.\d ms "
                        r"\(-?\d+% of full grad\)", got[4]), got[4]


def test_ablate_dw_constants_are_the_in_loop_decoder_weights():
    """grad_no_scanW's constants: the decoder's in-loop weights (JAX's
    ``IN_SCAN``), not its hoisted projections or anything outside it."""
    hp = HParams.create("use_labels=False,use_noise=True")
    hp.add_params(TINY)
    G = create_train_state(hp, 0, make_batch(hp, B=2, T_in=12, T_out=24),
                           device="cpu")[1]
    frozen = {n for n, _ in G.named_parameters() if ablate_dw.in_scan(n)}
    assert frozen == {
        "decoder.attention_rnn.w_ih", "decoder.attention_rnn.w_hh",
        "decoder.attention_rnn.b", "decoder.decoder_rnn.w_ih",
        "decoder.decoder_rnn.w_hh", "decoder.decoder_rnn.b",
        "decoder.query_w", "decoder.v_w", "decoder.loc_conv_w",
        "decoder.loc_dense_w"}


def test_ablate_batch_prints_samples_a_second(capsys):
    out = ablate_batch.run("cpu", batches=(2, 3), warmup=1, iters=1,
                           T_in=12, T_out=24, hp_over=TINY)
    got = lines(capsys)
    for line, B in zip(got[1:], (2, 3)):
        assert re.fullmatch(rf"B={B:<4d} g_step" + MS
                            + r"\s+\d+\.\d samples/s", line), line
    assert set(out) == {2, 3}


def test_ablate_unroll_says_unroll_is_ignored(capsys):
    out = ablate_unroll.run("cpu", unrolls=(8, 12), warmup=1, iters=2,
                            B=2, T_in=12, T_out=24, hp_over=TINY)
    got = lines(capsys)
    assert got[1] == ablate_deferred2.UNROLL_IGNORED
    for line, u in zip(got[2:], (8, 12)):
        assert re.fullmatch(rf"unroll={u:<3d} g_step" + MS
                            + r"  \(compile\+warm \d+s\)", line), line
    assert set(out) == {8, 12}


def test_alignment_demo_writes_checkpoints_and_alignment_arrays(
        tmp_path, monkeypatch, capsys):
    """``--iterations 2 --n_utts 12`` on the CPU with matplotlib taken
    away (``batch_size=4``: the demo keeps 8 of 12 wavs for validation,
    and its batch of 8 would leave no training batch): the last
    checkpoint, the metrics, and each validation's three alignments as
    (T_in, T_out) arrays."""
    from gantron_tpu_torch.utils import plotting

    monkeypatch.setattr(plotting, "available", lambda: False)
    alignment_demo.main(["-o", str(tmp_path), "--iterations", "2",
                         "--n_utts", "12", "--hparams", "batch_size=4",
                         "--device", "cpu"])
    run = tmp_path / "run"
    names = os.listdir(run)
    # A validation and a checkpoint at 1 and 2; keep-best retention may
    # have removed the first.
    assert 2 in [CheckpointManager.parse_name(n)[0] for n in names
                 if n.endswith(".ckpt")]
    assert "align.metrics.jsonl" in names
    arrays = sorted(os.listdir(run / "media"))
    assert [n for n in arrays if n.endswith(".png")] == []
    assert [n for n in arrays if n.endswith("_align.npy")] == [
        f"iter{i}_s{j}_align.npy" for i in (1, 2) for j in range(3)]
    a = np.load(run / "media" / "iter2_s0_align.npy")
    assert a.ndim == 2 and np.isfinite(a).all()
    assert np.allclose(a.sum(axis=0), 1.0, atol=1e-4)  # each frame's weights
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2] == f"Done. Alignment arrays (_align.npy) in {run}/media/"
    assert json.loads(out[-1])["kernel_launches"] == {"mel": 0, "qmm": 0}


def test_profile_decode_split_fields():
    hp = HParams.create("use_labels=False,use_noise=True")
    hp.add_params(dict(TINY, max_decoder_steps=20))
    cfg = WaveGlowConfig(n_flows=4, n_early_every=2, n_layers=2,
                         n_channels=16)
    out = profile_decode_split.profile(hp, cfg, "cpu", iters=2)
    assert set(out) == {"taco_ms", "waveglow_ms", "frames", "wg_share",
                        "device"}
    assert 1 <= out["frames"] <= 20 and out["device"] == "cpu"
    assert out["taco_ms"] > 0 and out["waveglow_ms"] > 0
    assert 0 < out["wg_share"] < 1


def notebook_cells():
    with open(NOTEBOOK) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


@pytest.mark.parametrize("plots", [True, False])
def test_notebook_runs_on_a_cpu_checkpoint(tmp_path, monkeypatch, plots):
    """The notebook's code cells in order, ``CKPT``, ``DEVICE`` and
    ``HPARAMS`` replaced by a tiny checkpoint written here: the decode,
    the plot cell (or its message without matplotlib), Griffin-Lim to
    ``demo_out.wav`` and ``force_style_emotions`` into
    ``notebook_samples/``."""
    from gantron_tpu_torch.utils import plotting

    monkeypatch.setenv("MPLBACKEND", "Agg")
    monkeypatch.setattr(plotting, "available", lambda: plots)
    hp_string = "use_labels=False,use_noise=True," + ",".join(
        f"{k}={v}" for k, v in TINY.items())
    hp = HParams.create(hp_string)
    state = create_train_state(hp, 0, make_batch(hp, B=2, T_in=12, T_out=24),
                               device="cpu")[0]
    ckpt = CheckpointManager(str(tmp_path / "run")).save(state, 3, 0.5)
    monkeypatch.chdir(tmp_path)
    cells = notebook_cells()
    edits = {"CKPT": repr(ckpt), "DEVICE": "'cpu'", "HPARAMS": repr(hp_string)}
    for name, value in edits.items():
        cells[0], n = re.subn(rf"^{name} = .*$", f"{name} = {value}",
                              cells[0], flags=re.M)
        assert n == 1, name
    ns = {}
    for cell in cells:
        exec(compile(cell, NOTEBOOK, "exec"), ns)
    L = ns["L"]
    assert 0 < L <= hp.max_decoder_steps
    assert ns["mel_np"].shape == (hp.n_mel_channels, L)
    from gantron_tpu_torch.data.wav import read_wav

    wav, rate = read_wav(str(tmp_path / "demo_out.wav"))
    assert rate == hp.sampling_rate and len(wav) > 0
    samples = sorted(os.listdir(tmp_path / "notebook_samples"))
    assert len(samples) == 3 * 2 and all(n.endswith(".npy") for n in samples)
    assert isinstance(ns["reached"], int)
    assert torch.is_tensor(ns["align"])
