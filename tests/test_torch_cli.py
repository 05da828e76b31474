"""The port's measuring harness on the CPU: the ``rtf`` and ``bench`` CLIs
(gantron_tpu_torch/cli/), ``utils/profiling.py``, the qmm op's fake
implementation, and the bfloat16 free-running decode that ``rtf
--taco_dtype bfloat16`` runs, held against JAX's bfloat16 ``infer``.

The ``rtf`` and ``bench`` CLIs run at tiny widths with ``--device cpu`` and
a narrow WaveGlow (the published one is too wide for a CPU test); what they
print is checked for ``rtf.py``'s and ``bench.py``'s fields, and that they
write nothing but where they are told to. ``qmm_op_cost`` needs a card:
only its refusal runs here.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as jax_bench
import gantron_tpu.models.tacotron2 as jax_taco
from gantron_tpu_torch.cli import bench, qmm_op_cost, rtf
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.models.waveglow import WaveGlowConfig
from gantron_tpu_torch.ops import quant
from gantron_tpu_torch.utils import profiling
from test_torch_conditioned import init_jax_weights
from test_torch_tacotron2 import TINY, port_model, texts, tiny_hparams
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_HPARAMS = ",".join(f"{k}={v}" for k, v in TINY.items()
                        if k not in ("use_noise", "use_labels"))
# hop 256, as the serving path's frames are: the streamed chunks tile.
NARROW_WAVEGLOW = WaveGlowConfig(n_flows=2, n_group=8, n_early_every=4,
                                 n_early_size=2, n_layers=2, n_channels=8,
                                 upsample_kernel=512, upsample_stride=256)


def run_rtf(capsys, *argv):
    result = rtf.main(["--device", "cpu", "--iters", "2", "--hparams",
                       TINY_HPARAMS + ",quantized_inference=True", *argv],
                      waveglow_config=NARROW_WAVEGLOW)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(result))
    return printed


@pytest.fixture
def repo_root_files():
    before = set(os.listdir(REPO))
    yield
    assert set(os.listdir(REPO)) == before, "a file appeared at the root"


def test_rtf_cli_b1_batch_and_streaming(tmp_path, monkeypatch, capsys,
                                        repo_root_files):
    monkeypatch.chdir(tmp_path)
    steps = TINY["max_decoder_steps"]
    one = run_rtf(capsys)
    assert one["unit"] == "RTF" and one["device"] == "cpu"
    assert one["gpu"] is None and one["taco_dtype"] == "float32"
    assert one["frames"] == steps  # random weights: the gate never fires
    assert one["audio_s"] == pytest.approx(one["frames"] * 256 / 22050)
    assert one["value"] == pytest.approx(one["synthesis_s"] / one["audio_s"])
    assert one["qmm_launches"] == 0 and "batch" not in one
    assert one["decoder_steps"] == steps

    two = run_rtf(capsys, "--batch", "2", "--result_dir",
                  str(tmp_path / "out"))
    assert two["unit"] == "audio_seconds/sec" and two["batch"] == 2
    with open(tmp_path / "out" / "serving_b2_result.json") as f:
        assert json.load(f) == two

    stream = run_rtf(capsys, "--streaming", "--chunk", "5", "--lookback",
                     "2")
    assert stream["chunk_steps"] == 5 and 0 < stream["ttfa_s"]
    assert stream["ttfa_s"] <= stream["synthesis_s"]
    assert stream["unit"] == "RTF" and stream["decoder_steps"] == steps
    assert os.listdir(tmp_path) == ["out"]


def test_rtf_cli_bfloat16_decode(tmp_path, monkeypatch, capsys,
                                 repo_root_files):
    monkeypatch.chdir(tmp_path)
    out = run_rtf(capsys, "--taco_dtype", "bfloat16")
    assert out["taco_dtype"] == "bfloat16" and np.isfinite(out["value"])
    assert os.listdir(tmp_path) == []


def test_bench_skips_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    record = bench.main([])
    printed = json.loads(capsys.readouterr().out.strip())
    assert printed == record
    assert record["skipped"] == "gpu-unavailable" and record["value"] is None
    assert record["unit"] == "steps/sec"
    assert record["metric"] == bench.metric_name(1)


def test_bench_batch_is_bench_py_batch():
    from gantron_tpu.config import HParams as JaxHParams

    jhp = JaxHParams.create("use_labels=False,use_noise=True,fp16_run=True")
    hp = HParams.create("use_labels=False,use_noise=True,fp16_run=True")
    ours, ref = bench.make_batch(hp), jax_bench.make_batch(jhp)
    assert ours.mels.shape == (32, 80, 640) and ours.text.shape == (32, 128)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    assert (bench.BATCH, bench.T_IN, bench.T_OUT, bench.WARMUP_CYCLES,
            bench.TIMED_CYCLES, bench.TRIALS) == (
        jax_bench.BATCH, jax_bench.T_IN, jax_bench.T_OUT,
        jax_bench.WARMUP_CYCLES, jax_bench.TIMED_CYCLES, jax_bench.TRIALS)


def test_profiling_on_the_cpu(tmp_path):
    timer = profiling.StepTimer(sync=True)
    timer.start(torch.device("cpu"), {"x": torch.ones(2)})
    x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert 0 < timer.stop(x, [x], {"y": x})
    calls = []
    mean = profiling.benchmark(lambda a: calls.append(a) or a @ a,
                               torch.ones(32, 32), warmup=2, iters=5)
    assert len(calls) == 7 and mean > 0
    with profiling.trace(str(tmp_path / "t"), "cpu.json") as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "t" / "cpu.json") as f:
        assert json.load(f)["traceEvents"]
    assert any(e.key == "aten::matmul" for e in prof.key_averages())


def test_qmm_op_cost_needs_a_card(monkeypatch):
    """The op-cost measurement refuses to run without a card rather than
    timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        qmm_op_cost.main(["--pairs", "1"])


def test_qmm_op_fake_implementation():
    """Under ``FakeTensorMode`` the op gives (B, O) in x's dtype on x's
    device without computing, for any batch: what lets ``torch.export``
    trace the decode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.empty(3, 40, dtype=dtype)
            q = torch.empty(40, 96, dtype=torch.int8)
            scale = torch.empty(96)
            y = torch.ops.gantron_tpu_torch.qmm(x, q, scale)
            assert y.shape == (3, 96) and y.dtype == dtype
            y = quant.qmm(x, quant.QuantizedMatrix(q, scale))
            assert y.shape == (3, 96)
    assert quant.qmm.launches == 0


def test_bfloat16_decode_matches_jax(monkeypatch):
    """``rtf --taco_dtype bfloat16``: every weight and BatchNorm statistic
    cast to bfloat16, as rtf.py casts the JAX variables, then 10 free-running
    steps with the style injected and prenet dropout off, against JAX's
    jitted bfloat16 ``infer`` on the same weights: within 5e-2 (bfloat16
    keeps 8 bits of mantissa, and the decode feeds each frame back)."""
    monkeypatch.setattr(jax_taco, "_dropout", lambda x, r, k: x)
    jhp, hp = tiny_hparams(quantized_inference=True, max_decoder_steps=10,
                           gate_threshold=1.0)
    variables = init_jax_weights(jhp)
    lengths = np.array([9, 6], np.int32)
    ids = texts(hp, lengths, 9)
    style = np.random.RandomState(1).rand(2, 1, hp.noise_size) \
        .astype(np.float32)
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                  variables)
    model = jax_taco.Tacotron2(jhp)
    # Jitted, as rtf.py runs it.
    j = jax.jit(lambda v, i, s, n: model.apply(
        v, i, s, None, None, None, False, method=model.infer, text_lengths=n,
        rngs={"dropout": jax.random.PRNGKey(0),
              "noise": jax.random.PRNGKey(1)}))(
        bf16, jnp.asarray(ids), jnp.asarray(style, jnp.bfloat16),
        jnp.asarray(lengths))
    port = port_model(variables, hp).to(torch.bfloat16)
    p = port.infer(torch.from_numpy(ids), torch.from_numpy(style),
                   text_lengths=torch.from_numpy(lengths))
    for name, a, b in zip(("mel", "mel_postnet", "gate"), p, j):
        assert a.dtype == torch.bfloat16, name
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        assert np.isfinite(a).all() and a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=5e-2, rtol=5e-2, err_msg=name)
