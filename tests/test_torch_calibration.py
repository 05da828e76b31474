"""Port parity of the identification machinery's evaluation side: the
calibrated knob (eval/calibration.py), the mode-study metrics
(eval/mode_study.py), the rest of eval/sampling.py (coded styles, the
attribution grid, the latent-separation probe) and
``Synthesizer.infer_mel(level=)``, against the JAX package's.

The numpy functions are held equal on seeded inputs. The decodes run from
one set of JAX weights on both sides with dropout off, the gate pinned
(no sample stops) and the style draws injected: the port seeds its own
draws (``measure_knob`` from (seed, code_dim), not JAX's one key for every
dim), so the tests pass JAX's draws in.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gantron_tpu.eval.calibration as jax_cal
import gantron_tpu.eval.mode_study as jax_ms
import gantron_tpu.eval.sampling as jax_sampling
import gantron_tpu.models.tacotron2 as jax_taco
from gantron_tpu.train.state import create_train_state as jax_create_state
from gantron_tpu.tts import Synthesizer as JaxSynthesizer
from gantron_tpu_torch.data import toy
from gantron_tpu_torch.eval import calibration as cal
from gantron_tpu_torch.eval import mode_study as ms
from gantron_tpu_torch.eval import sampling
from gantron_tpu_torch.models.modules import disable_dropout
from gantron_tpu_torch.tts import Synthesizer
from gantron_tpu_torch.utils.jax_weights import tacotron2_from_jax
from test_torch_identification import (GATE_NEVER,  # noqa: F401
                                       one_torch_thread, pin_gate)
from test_torch_train import np_tree, port_hp
from test_train_step import synth_batch, tiny_hp

HP_OVER = dict(style_code_dims=2, style_code_levels=3)


@pytest.fixture(scope="module")
def models():
    """JAX's Tacotron2 and variables (gate pinned) and the port's model of
    the same weights, dropout off on both sides."""
    jhp = tiny_hp(**HP_OVER)
    hp = port_hp(jhp)
    state, gen, *_ = jax_create_state(jhp, jax.random.PRNGKey(0),
                                      tuple(synth_batch(jhp, B=2)))
    params = pin_gate(np_tree(state.g_params), GATE_NEVER)
    stats = np_tree(state.g_batch_stats)
    port = disable_dropout(tacotron2_from_jax(params, stats, hp, "cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_taco, "_dropout", lambda x, r, k: x)
        yield dict(jhp=jhp, hp=hp, gen=gen, port=port,
                   variables={"params": params, "batch_stats": stats},
                   text=np.array([[12, 30, 41, 7, 22, 19, 3]], np.int32))


# -- calibration --------------------------------------------------------------
def test_pava_matches_jax():
    rng = np.random.RandomState(0)
    for n in (1, 5, 17):
        y = rng.randn(n)
        w = rng.rand(n) + 0.1
        np.testing.assert_array_equal(cal.pava(y), jax_cal.pava(y))
        np.testing.assert_array_equal(cal.pava(y, w), jax_cal.pava(y, w))
    with pytest.raises(ValueError):
        cal.pava(np.ones((2, 2)))


@pytest.mark.parametrize("sign", [1, -1])
def test_knob_calibration_matches_jax(sign):
    """Fit (with the knob's direction detected), queries in both
    directions, clamping outside the range, coverage and the JSON round
    trip, equal to JAX's."""
    rng = np.random.RandomState(3)
    codes = np.linspace(0.05, 0.95, 11)
    levels = sign * 2.0 * codes[:, None] + 0.3 * rng.randn(11, 8)
    order = rng.permutation(11)
    j = jax_cal.KnobCalibration.fit(codes[order], levels[order], code_dim=1)
    p = cal.KnobCalibration.fit(codes[order], levels[order], code_dim=1)
    assert p.sign == j.sign == sign
    assert p.to_json() == j.to_json()
    q = np.linspace(-3, 3, 13)
    np.testing.assert_array_equal(p.code_for_level(q), j.code_for_level(q))
    np.testing.assert_array_equal(p.level_for_code(np.linspace(0, 1, 7)),
                                  j.level_for_code(np.linspace(0, 1, 7)))
    assert p.code_for_level(0.4) == j.code_for_level(0.4)
    assert p.level_range == j.level_range
    assert p.coverage(-1.0, 1.0) == j.coverage(-1.0, 1.0)
    back = cal.KnobCalibration.from_json(p.to_json())
    assert back.to_json() == p.to_json()
    with pytest.raises(ValueError):
        cal.KnobCalibration([0.2, 0.1], [0.0, 1.0], 1)


def test_vector_calibration_matches_jax():
    rng = np.random.RandomState(4)
    codes = np.linspace(0.05, 0.95, 7)
    M = np.array([[1.5, 0.4], [-0.3, 0.9]])
    sweeps = []
    for d in range(2):
        x = np.full((7, 2), 0.5)
        x[:, d] = codes
        lv = (x - 0.5) @ M.T + np.array([0.2, -0.1])
        sweeps.append((codes, lv[:, None, :] + 0.05 * rng.randn(7, 5, 2)))
    j = jax_cal.VectorCalibration.fit(sweeps)
    p = cal.VectorCalibration.fit(sweeps)
    assert p.to_json() == j.to_json()
    assert p.condition_number == j.condition_number
    code = np.array([0.3, 0.8])
    np.testing.assert_array_equal(p.levels_for_code(code),
                                  j.levels_for_code(code))
    for targets in ([0.1, 0.0], [5.0, -5.0]):
        pc, pin = p.code_for_levels(targets)
        jc, jin = j.code_for_levels(targets)
        np.testing.assert_array_equal(pc, jc)
        assert pin == jin
    assert cal.VectorCalibration.from_json(p.to_json()).to_json() \
        == p.to_json()


def _jax_nuisance(seed, n_draws, noise_size):
    k_nuis, _ = jax.random.split(jax.random.PRNGKey(77 + seed))
    return np.array(jax.random.uniform(k_nuis, (n_draws, 1, noise_size)))


def test_measure_knob_matches_jax(models):
    """The sweep (11 codes x 4 draws in one decode) with JAX's nuisance
    injected: the same codes and levels; the port's own nuisance is seeded
    from (seed, code_dim), so two dims' sweeps draw different ones."""
    hp, port = models["hp"], models["port"]
    band = ms.band_channels(hp, 4000.0, 4800.0)
    score = lambda m: ms.hiband_level(m, band)  # noqa: E731
    for code_dim in (0, 1):
        jc, jl = jax_cal.measure_knob(models["gen"], models["variables"],
                                      models["jhp"], models["text"], score,
                                      n_draws=4, seed=2, code_dim=code_dim,
                                      max_steps=12)
        pc, pl = cal.measure_knob(port, hp, models["text"], score, n_draws=4,
                                  seed=2, code_dim=code_dim, max_steps=12,
                                  nuisance=_jax_nuisance(2, 4, hp.noise_size))
        np.testing.assert_array_equal(pc, jc)
        assert pl.shape == (11, 4)
        np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    drawn = []
    for code_dim in (0, 1, 1):
        captured = {}
        real = port.infer

        def infer(text, style, *a, **k):
            captured["style"] = style.clone()
            return real(text, style, *a, **k)

        port.infer = infer
        try:
            cal.measure_knob(port, hp, models["text"], score, n_draws=2,
                             code_values=[0.2, 0.7], code_dim=code_dim,
                             max_steps=4)
        finally:
            del port.infer
        nuis = captured["style"].clone()
        nuis[:, 0, code_dim] = 0.0
        drawn.append(nuis)
    assert not torch.equal(drawn[0][:, 0, 2:], drawn[1][:, 0, 2:])
    assert torch.equal(drawn[1], drawn[2])


def test_infer_mel_level_matches_jax(models, tmp_path):
    """``load_calibration`` (a path, a document wrapping the curve, the
    bare JSON), ``style_for_level`` with JAX's nuisance, and
    ``infer_mel(level=)`` at B = 1 and B = 3 (one style tiled): the mels
    and lengths of JAX's ``infer_mel(level=)``; ``level`` with ``style``
    raises on both sides, as does a level without a calibration."""
    hp, jhp = models["hp"], models["jhp"]
    curve = cal.KnobCalibration.fit(np.linspace(0.05, 0.95, 5),
                                    np.array([0.1, 0.3, 0.35, 0.8, 1.0]),
                                    code_dim=1)
    path = tmp_path / "knob.json"
    path.write_text(json.dumps({"calibration": json.loads(curve.to_json()),
                                "checkpoint": "x"}))
    j_synth = JaxSynthesizer(models["gen"], models["variables"], jhp)
    j_synth.load_calibration(str(path))
    synth = Synthesizer(hp, models["port"], device="cpu")
    with pytest.raises(ValueError, match="calibration"):
        synth.infer_mel(models["text"], level=0.5)
    synth.load_calibration(str(path))
    assert synth.calibration.to_json() == curve.to_json()
    synth.load_calibration(curve.to_json())
    seed, level = 3, 0.6
    j_style = np.array(j_synth.style_for_level(level, seed))
    nuis = np.array(jax.random.uniform(jax.random.PRNGKey(seed),
                                       (1, 1, hp.noise_size)))
    p_style = synth.calibration.style_for_level(level, None, hp.noise_size,
                                                nuisance=nuis)
    np.testing.assert_array_equal(p_style.numpy(), j_style)
    synth.style_for_level = lambda lv, s=0: \
        synth.calibration.style_for_level(lv, None, hp.noise_size,
                                          nuisance=nuis)
    one = models["text"]
    batch = np.zeros((3, 9), np.int32)
    batch[0, :7] = one[0]
    batch[1, :5] = one[0, :5]
    batch[2] = np.arange(1, 10)
    for ids in (one, batch):
        j_out = j_synth.infer_mel(ids, level=level, seed=seed)
        p_out = synth.infer_mel(ids, level=level, seed=seed)
        if ids.shape[0] == 1:
            j_out, p_out = [j_out], [p_out]
        assert len(p_out) == len(j_out) == ids.shape[0]
        for (pm, pl), (jm, jl) in zip(p_out, j_out):
            assert pl == jl == hp.max_decoder_steps
            np.testing.assert_allclose(pm.numpy(), jm, atol=1e-5)
    for s in (synth, j_synth):
        with pytest.raises(ValueError, match="either style or level"):
            s.infer_mel(one, style=np.zeros((1, 1, hp.noise_size),
                                            np.float32), level=0.5)


# -- sampling -----------------------------------------------------------------
@pytest.mark.parametrize("code", [1, [0, 2, 1, 2], [2, 0],
                                  [[0, 1], [1, 2], [2, 2], [0, 0]], [0, 1, 2]])
def test_coded_style_matches_jax(code):
    """Every form of ``code`` (one level, per sample, per dim, the grid)
    with JAX's nuisance: equal styles; a shape that fits none raises."""
    key = jax.random.PRNGKey(5)
    nuis = np.array(jax.random.uniform(key, (4, 1, 8)))
    args = (4, 8, code, 2, 3)
    if np.asarray(code).shape == (3,):
        with pytest.raises(ValueError):
            jax_sampling.coded_style(key, *args)
        with pytest.raises(ValueError):
            sampling.coded_style(None, *args, nuisance=nuis)
        return
    j = jax_sampling.coded_style(key, *args)
    p = sampling.coded_style(None, *args, nuisance=nuis)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    gen = torch.Generator().manual_seed(0)
    drawn = sampling.coded_style(gen, *args)
    np.testing.assert_array_equal(drawn[:, 0, :2].numpy(),
                                  np.asarray(j)[:, 0, :2])
    for bad in (dict(code_dims=9), dict(code_levels=1)):
        kw = {**dict(code_dims=2, code_levels=3), **bad}
        with pytest.raises(ValueError):
            sampling.coded_style(gen, 4, 8, 0, **kw)


def test_separation_ratio_and_grid_shape_match_jax():
    rng = np.random.RandomState(6)
    mels = rng.randn(6, 5, 10).astype(np.float32)
    lengths = rng.randint(1, 11, 6)
    assert sampling.code_separation_ratio(mels, lengths, 3, 2) == \
        jax_sampling.code_separation_ratio(mels, lengths, 3, 2)
    assert sampling._masked_l1(mels, lengths, 0, 4) == \
        jax_sampling._masked_l1(mels, lengths, 0, 4)
    for over in (dict(), dict(style_code_dims=2, style_code_levels=3),
                 dict(style_code_dims=1, style_code_levels=8,
                      validation_sample_diversity=8),
                 dict(validation_sample_diversity=9)):
        jhp = tiny_hp(**over)
        assert sampling.probe_grid_shape(port_hp(jhp)) == \
            jax_sampling.probe_grid_shape(jhp)


@pytest.mark.parametrize("over,dim", [
    (dict(style_code_dims=2, style_code_levels=3), None),
    (dict(style_code_dims=2, style_code_levels=3), 1),
    (dict(), None)])
def test_separation_grid_styles_structure(over, dim):
    """The port's grid has JAX's structure: level-major rows, the nuisance
    shared across levels, the swept code dims on the trained grid, the
    other code dims shared across levels; a continuous code repeats each
    level's style over the draws."""
    hp = port_hp(tiny_hp(**over))
    L, S = 3, 2
    g = sampling.separation_grid_styles(hp, L, S,
                                        torch.Generator().manual_seed(1),
                                        dim=dim).numpy()
    assert g.shape == (L * S, 1, hp.noise_size)
    rows = g[:, 0].reshape(L, S, -1)
    if not over:
        assert (rows == rows[:, :1]).all()
        return
    levels = (np.round(np.linspace(0, 2, L)) + 0.5) / 3
    swept = [0, 1] if dim is None else [dim]
    for lv in range(L):
        np.testing.assert_array_equal(rows[lv][:, swept],
                                      np.full((S, len(swept)), levels[lv],
                                              np.float32))
    fixed = [d for d in range(hp.noise_size) if d not in swept]
    assert (rows[:, :, fixed] == rows[:1, :, fixed]).all()
    with pytest.raises(ValueError):
        sampling.separation_grid_styles(hp, L, S, torch.Generator(), dim=5)


@pytest.mark.parametrize("dim", [None, 0])
def test_latent_separation_matches_jax(models, dim):
    """One grid decode with JAX's grid injected: the same separation ratio
    and spread."""
    jhp = tiny_hp(**HP_OVER, max_decoder_steps=10)
    hp = port_hp(jhp)
    key = jax.random.PRNGKey(9)
    j_ratio, j_spread = jax_sampling.latent_separation(
        models["gen"], models["variables"], jhp, jnp.asarray(models["text"]),
        key, dim=dim)
    L, S = sampling.probe_grid_shape(hp)
    style = torch.from_numpy(np.array(jax_sampling.separation_grid_styles(
        jhp, L, S, jax.random.split(key)[0], dim=dim)))
    p_ratio, p_spread = sampling.latent_separation(
        models["port"], hp, models["text"], torch.Generator(), dim=dim,
        style=style)
    assert abs(p_ratio - j_ratio) <= 1e-4 * abs(j_ratio)
    assert abs(p_spread - j_spread) <= 1e-4 * abs(j_spread)


def test_attribution_level_grid_matches_jax(models):
    """(N styles x M dropout streams) band levels with JAX's styles: the
    same grid, one band -> (N, M), two bands -> (N, M, 2)."""
    jhp, hp = models["jhp"], models["hp"]
    bands = [ms.band_channels(hp, 4000.0, 4800.0),
             ms.hiband_channels(hp)]
    k_style, _ = jax.random.split(jax.random.PRNGKey(100 + 1))
    styles = np.array(jax.random.uniform(k_style, (3, 1, hp.noise_size)))
    j = jax_sampling.attribution_level_grid(
        models["gen"], models["variables"], jhp, models["text"], bands, 3, 2,
        seed=1, max_decoder_steps=8)
    p = sampling.attribution_level_grid(
        models["port"], hp, models["text"], bands, 3, 2, seed=1,
        max_decoder_steps=8, styles=styles)
    assert p.shape == (3, 2, 2)
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-5)
    one = sampling.attribution_level_grid(
        models["port"], hp, models["text"], bands[0], 3, 2, seed=1,
        max_decoder_steps=8, styles=styles)
    np.testing.assert_array_equal(one, p[:, :, 0])


# -- mode study ---------------------------------------------------------------
def test_mode_study_metrics_match_jax():
    """The copied numpy metrics on seeded inputs, equal to JAX's."""
    hp = port_hp(tiny_hp())
    rng = np.random.RandomState(8)
    for lo, hi in ((5000.0, None), (4000.0, 4800.0)):
        np.testing.assert_array_equal(ms.band_channels(hp, lo, hi),
                                      jax_ms.band_channels(hp, lo, hi))
    np.testing.assert_array_equal(ms.hiband_channels(hp),
                                  jax_ms.hiband_channels(hp))
    ch = ms.hiband_channels(hp)
    mel = rng.randn(hp.n_mel_channels, 30)
    assert ms.hiband_level(mel, ch) == jax_ms.hiband_level(mel, ch)
    np.testing.assert_array_equal(ms.hiband_series(mel[None], ch),
                                  jax_ms.hiband_series(mel[None], ch))
    pairs = [(rng.randn(hp.n_mel_channels, 20), L) for L in (20, 12, 3)]
    assert ms.texture_stats(pairs, ch) == jax_ms.texture_stats(pairs, ch)
    by_mode = {0: list(rng.randn(5)), 1: list(rng.randn(4) + 2)}
    anchors = ms.mode_anchor_levels(by_mode)
    assert anchors == jax_ms.mode_anchor_levels(by_mode)
    levels = rng.randn(6, 5) + np.linspace(-1, 1, 6)[:, None]
    assert ms.attribution_grid_stats(levels, 0.0) == \
        jax_ms.attribution_grid_stats(levels, 0.0)
    assert ms.attribution_grid_stats(np.ones((3, 2)), 0.0) == \
        jax_ms.attribution_grid_stats(np.ones((3, 2)), 0.0)
    a, b = rng.randn(6, 5), rng.randn(6, 5)
    modes = ms.joint_mode_grid(a, b, 0.1, -0.1)
    np.testing.assert_array_equal(modes,
                                  jax_ms.joint_mode_grid(a, b, 0.1, -0.1))
    assert ms.attribution_grid_stats_multi(modes, 4) == \
        jax_ms.attribution_grid_stats_multi(modes, 4)
    cells = np.array([[0, 0], [0, 1], [1, 0], [1, 1]])
    lv = rng.randn(4, 3, 2)
    assert ms.code_binding_stats(lv, cells) == \
        jax_ms.code_binding_stats(lv, cells)
    cm = rng.randint(0, 4, (4, 5))
    assert ms.code_mode_coverage(cm, 4) == jax_ms.code_mode_coverage(cm, 4)
    gen_levels = rng.randn(9) + 1
    assert ms.commitment_stats(gen_levels, anchors) == \
        jax_ms.commitment_stats(gen_levels, anchors)
    codes = np.linspace(0.05, 0.95, 5)
    cl = codes[:, None] + 0.2 * rng.randn(5, 4)
    assert ms.continuous_control_stats(codes, cl, -0.2, 1.1, n_perm=50) == \
        jax_ms.continuous_control_stats(codes, cl, -0.2, 1.1, n_perm=50)


def test_real_anchors_and_levels_match_jax(tmp_path):
    """``compute_real_anchors`` on the composed corpus (its mode bit's
    band) and ``compute_real_levels`` on the leveled corpus, both
    featurized on the CPU, against JAX's within the mel's tolerance. Each
    side reads its own copy of the corpus: the two datasets share the mel
    cache's file names."""
    hp = port_hp(tiny_hp())
    jhp = tiny_hp()
    band = ms.band_channels(hp, 3900.0, 4900.0)
    for build, compute, j_compute in (
            (toy.build_composed_corpus, ms.compute_real_anchors,
             jax_ms.compute_real_anchors),
            (toy.build_leveled_corpus, ms.compute_real_levels,
             jax_ms.compute_real_levels)):
        out = {}
        for side in ("port", "jax"):
            wav_dir, train, _, labels = build(
                str(tmp_path / build.__name__ / side), n_utts=8, n_train=6)
            if side == "port":
                out[side] = compute(train, wav_dir, labels, hp, band,
                                    device="cpu")
            else:
                out[side] = j_compute(train, wav_dir, labels, jhp, band)
        p, j = out["port"], out["jax"]
        assert sorted(p) == sorted(j)
        for k, jv in j.items():
            if isinstance(jv, list):
                np.testing.assert_allclose(p[k], jv, atol=2e-3, err_msg=k)
            elif k == "spearman_p":
                assert abs(p[k] - jv) <= 1e-2, k
            else:
                assert abs(p[k] - jv) <= 2e-3, k
