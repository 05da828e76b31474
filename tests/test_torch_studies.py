"""The port's study campaigns end to end on the CPU
(gantron_tpu_torch/scripts/): each of the six GAN studies and evidence_run
through ``python -m gantron_tpu_torch.scripts.run_study --device cpu`` at a
tiny size (2 iterations, a 14- or 24-utterance corpus, widths of 8-16,
8 decoder steps, grids of a few cells), the seven arms as seven processes
at once, each on one torch thread. Then ``--analyze_only`` rereads each
study's checkpoint, the six post-hoc tools run over those outputs, and the
repository's three ``scripts/summarize_*.py`` read them.

Each JSON is held to the committed JAX evidence file of the same study:
the same top-level fields, in the same order (the JAX scripts' results, on
a TPU, under docs/evidence_r*/).
"""

import json
import os
import subprocess
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, "docs")

# Narrow widths, 8 decoder steps, batch 4 and one validation (at
# iteration 2) over the study model's configuration.
TINY = ("symbols_embedding_dim=16,encoder_embedding_dim=16,"
        "attention_rnn_dim=16,decoder_rnn_dim=16,prenet_dim=8,"
        "attention_dim=8,attention_location_n_filters=4,"
        "attention_location_kernel_size=5,postnet_embedding_dim=16,"
        "discriminator_dim=16,max_decoder_steps=8,batch_size=4,"
        "iters_per_checkpoint=2")
GRID = "--n_styles 4 --n_dropout 2"

# arm -> (output root under the campaign's directory, --n_utts, the
# study's own arguments, its JSON in the arm's directory, the committed
# JAX file of that study).
ARMS = {
    "mode/gan": ("modestudy", 14, "--samples 4", "gan/mode_study.json",
                 "evidence_r4/mode_study/infogan_bit_mode_study.json"),
    "texture/gan": ("texstudy", 14, "--samples 4",
                    "gan/texture_study.json",
                    "evidence_r4/texstudy/gan_texture.json"),
    "composed/full": ("composedstudy", 14, GRID + " --samples 4",
                      "full/composed_study.json",
                      "evidence_r4/composed/full.json"),
    "factorial/bit2x2_rescue_q": (
        ".", 14, GRID + " --code_draws 2",
        "bit2x2_rescue_q/factorial_study.json",
        "evidence_r4/factorial/bit2x2.json"),
    "continuous/cont_warm": ("contstudy", 14, GRID + " --code_draws 2",
                             "cont_warm/continuous_study.json",
                             "evidence_r5/continuous/cont_warm_s0.json"),
    "vector/vec_warm": ("vectorstudy", 14, GRID + " --code_draws 2",
                        "vec_warm/vector_study.json",
                        "evidence_r5/vector/vec_warm_cap068_s0.json"),
    # Evidence's study decodes 24 steps: its classifier crops 24 frames.
    "evidence/gan": ("evidence", 24, "--samples 2 --classifier_epochs 1",
                     "gan/evidence.json",
                     "evidence_r4/k2_evidence/gan_evidence.json"),
}
EVIDENCE_HPARAMS = TINY.replace("max_decoder_steps=8", "max_decoder_steps=24")


def committed_keys(rel):
    with open(os.path.join(DOCS, rel)) as f:
        d = json.load(f)
    return list((d[0] if isinstance(d, list) else d).keys())


def run_arms(root, analyze_only=False):
    """run_study for every arm at once (each its own process and output
    root); returns {arm: (rc, progress.log)}."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for arm, (sub, n_utts, extra, _, _) in ARMS.items():
        if analyze_only and arm.startswith("evidence/"):
            continue  # evidence_run has no --analyze_only
        hparams = EVIDENCE_HPARAMS if arm.startswith("evidence/") else TINY
        cmd = [sys.executable, "-m", "gantron_tpu_torch.scripts.run_study",
               "--arm", arm, "-o", os.path.join(root, sub),
               "--iterations", "2", "--n_utts", str(n_utts),
               "--device", "cpu", "--hparams", hparams,
               "--study_args", extra, "--timeout", "600"]
        if analyze_only:
            cmd.append("--analyze_only")
        procs[arm] = subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=subprocess.DEVNULL)
    out = {}
    try:
        for arm, p in procs.items():
            rc = p.wait(timeout=900)
            with open(os.path.join(root, ARMS[arm][0],
                                   "progress.log")) as f:
                out[arm] = (rc, f.read())
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


def arm_json(root, arm):
    with open(os.path.join(root, ARMS[arm][0], ARMS[arm][3])) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """The seven arms trained and scored, then rerun with --analyze_only:
    (root, first runs' logs, first runs' JSONs, reruns' logs)."""
    root = str(tmp_path_factory.mktemp("campaign"))
    first = run_arms(root)
    for arm, (rc, log) in first.items():
        assert rc == 0, f"{arm}:\n{log[-4000:]}"
    results = {arm: arm_json(root, arm) for arm in ARMS}
    again = run_arms(root, analyze_only=True)
    return root, first, results, again


@pytest.mark.parametrize("arm", list(ARMS))
def test_study_writes_the_jax_fields(campaign, arm):
    """The study's JSON has the committed JAX file's top-level fields in
    its order, names the CPU, ran 2 iterations, and its log reports the
    kernels' launches (none on the CPU)."""
    root, first, results, _ = campaign
    result = results[arm]
    assert list(result.keys()) == committed_keys(ARMS[arm][4])
    assert result["device"] == "cpu"
    assert result["iterations"] == 2
    assert result["variant"] == arm.split("/")[1]
    assert result["n_utts"] == ARMS[arm][1]
    log = first[arm][1]
    assert '{"kernel_launches": {"mel": 0, "qmm": 0}}' in log, log[-2000:]
    assert "=== rc=0" in log


@pytest.mark.parametrize("arm", [a for a in ARMS
                                 if not a.startswith("evidence/")])
def test_analyze_only_rereads_the_checkpoint(campaign, arm):
    """--analyze_only trains nothing: the iteration comes from the
    checkpoint's name, the JSON says so, and its fields stay the JAX
    file's."""
    root, first, results, again = campaign
    rc, log = again[arm]
    assert rc == 0, log[-4000:]
    assert "--analyze_only" in log
    result = arm_json(root, arm)
    assert result["analyze_only"] is True
    assert result["train_seconds"] is None
    assert result["iterations"] == 2
    assert list(result.keys()) == list(results[arm].keys())
    assert result["final_validation"] == results[arm]["final_validation"]


@pytest.fixture(scope="module")
def post_hoc(campaign):
    """The six post-hoc tools over the campaign's checkpoints, run in this
    process: {tool: its result}."""
    from gantron_tpu_torch.scripts import (calibrate_factor_sensor,
                                           calibrate_knob,
                                           calibrate_rescue_floor,
                                           continuous_extrapolation,
                                           mode_attribution, vector_unmix)

    root = campaign[0]
    mode_dir = os.path.join(root, "modestudy", "gan")
    cont = os.path.join(root, "contstudy")
    out = {}
    out["mode_attribution"] = mode_attribution.main(
        ["--run_dir", mode_dir, "--variant", "gan", "--iterations", "2",
         "--hparams", TINY, "--n_styles", "4", "--n_dropout", "2",
         "--device", "cpu"])
    out["mode_attribution_int8"] = mode_attribution.main(
        ["--run_dir", mode_dir, "--variant", "gan", "--iterations", "2",
         "--hparams", TINY + ",quantized_inference=True", "--n_styles", "4",
         "--n_dropout", "2", "--select", "best", "--device", "cpu"])
    out["calibrate_knob"] = calibrate_knob.main(
        ["--study_root", cont, "--n_codes", "5", "--code_draws", "2",
         "--n_targets", "2", "--check_draws", "2", "--device", "cpu"])
    out["continuous_extrapolation"] = continuous_extrapolation.main(
        ["--study_root", cont, "--n_codes", "5", "--code_draws", "2",
         "--device", "cpu"])
    out["vector_unmix"] = vector_unmix.main(
        ["--root", os.path.join(root, "vectorstudy"), "--seeds", "0",
         "--n_draws", "2", "--n_utts", "14", "--hparams", TINY,
         "-o", os.path.join(root, "unmix.json"), "--device", "cpu"])
    out["calibrate_factor_sensor"] = calibrate_factor_sensor.main(
        ["-o", root, "--device", "cpu"])
    out["calibrate_rescue_floor"] = calibrate_rescue_floor.main(
        ["-o", os.path.join(root, "composedstudy"), "--device", "cpu"])
    return root, out


def test_mode_attribution_writes_the_jax_fields(post_hoc):
    root, out = post_hoc
    keys = committed_keys(
        "evidence_r4/mode_study/infogan_bit_warm_rerun_mode_attribution_"
        "best.json")
    for name, file in (("mode_attribution", "mode_attribution.json"),
                       ("mode_attribution_int8",
                        "mode_attribution_best.json")):
        with open(os.path.join(root, "modestudy", "gan", file)) as f:
            written = json.load(f)
        assert list(written.keys()) == keys
        assert written["checkpoint"] == out[name]["checkpoint"]
        assert written["n_styles"] == 4 and written["n_dropout"] == 2
        assert written["device"] == "cpu"
    assert out["mode_attribution_int8"]["selection"] == "best"
    assert "quantized_inference=True" in \
        out["mode_attribution_int8"]["hparams_override"]


def test_knob_tools_write_the_jax_fields(post_hoc):
    """calibrate_knob and continuous_extrapolation read the arm's
    continuous_study.json and write into the study root."""
    root, out = post_hoc
    cont = os.path.join(root, "contstudy")
    for name, file, ref in (
            ("calibrate_knob", "calibrated_cont_warm_s0.json",
             "evidence_r5/continuous/calibrated_cont_warm_s0.json"),
            ("continuous_extrapolation", "extrapolation_cont_warm_s0.json",
             "evidence_r5/continuous/extrapolation_cont_warm_s0.json")):
        with open(os.path.join(cont, file)) as f:
            written = json.load(f)
        assert list(written.keys()) == committed_keys(ref), name
        assert written["device"] == "cpu"
    assert len(out["calibrate_knob"]["targets"]) == 2
    assert len(out["continuous_extrapolation"]["code_values"]) == 5


def test_vector_unmix_and_the_calibrations_write_the_jax_fields(post_hoc):
    root, out = post_hoc
    with open(os.path.join(root, "unmix.json")) as f:
        unmix = json.load(f)
    assert [list(r.keys()) for r in unmix] == \
        [committed_keys("evidence_r5/vector/unmix_grid.json")]
    assert unmix[0]["n_targets"] == 9
    with open(os.path.join(root, "factor_sensor_calibration.json")) as f:
        sensor = json.load(f)
    assert [r["arm"] for r in sensor["rows"]] == ["bit2x2_rescue_q"]
    assert len(sensor["rows"][0]["per_dim"]) == 2
    assert set(committed_keys(
        "evidence_r4/factorial/factor_sensor_calibration.json")) \
        >= set(sensor) >= {"rows", "statistic", "min_dim_both_bands",
                           "min_dim_one_band", "min_dim_no_band"}
    with open(os.path.join(root, "composedstudy",
                           "rescue_floor_calibration.json")) as f:
        floor = json.load(f)
    assert [r["arm"] for r in floor["rows"]] == ["full"]
    assert set(committed_keys(
        "evidence_r4/rescue/rescue_floor_calibration.json")) \
        >= set(floor) >= {"rows", "statistic", "healthy_band",
                          "collapsed_band", "non_identification_separations"}


@pytest.mark.parametrize("summarizer", ["summarize_continuous",
                                        "summarize_round4",
                                        "summarize_texture"])
def test_summarizers_read_the_outputs(post_hoc, tmp_path, summarizer):
    """The repository's summarizers (JSON readers shared by both packages)
    tabulate the port's outputs."""
    root = post_hoc[0]
    arg = {"summarize_continuous": os.path.join(root, "contstudy"),
           "summarize_round4": root,
           "summarize_texture": os.path.join(root, "texstudy")}[summarizer]
    out = tmp_path / "summary.json"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", summarizer + ".py"),
         arg, "-o", str(out)], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    summary = json.loads(out.read_text())
    if summarizer == "summarize_continuous":
        assert [(a["arm"], a["device"]) for a in summary["arms"]] \
            == [("cont_warm", "cpu")]
    elif summarizer == "summarize_round4":
        assert [a["arm"] for a in summary["mode_arms"]] == ["gan"]
        assert summary["mode_arms"][0]["grid"] == "4x2"
        assert [a["arm"] for a in summary["texture_arms"]] == ["gan"]
        assert [a["arm"] for a in summary["factorial_arms"]] \
            == ["bit2x2_rescue_q"]
    else:
        assert [(r["arm"], r["seed"]) for r in summary] == [("gan", 0)]
