"""Mode-commitment metrics for the one-to-many (bimodal) corpus study (a
copy of gantron_tpu/eval/mode_study.py; the port keeps its own, so that it
imports nothing of the JAX package).

GANtron's design thesis is that injected noise makes text->mel one-to-many
(reference model.py:184-191, 273-279). On ``data/toy.py``'s bimodal corpus
each utterance randomly carries (or lacks) a >=5 kHz noise texture hidden
from text and labels, so the conditional distribution p(mel | text) has two
modes. These helpers reduce a mel to a scalar "high-band level" and score
how close generated samples land to the REAL modes versus the MSE-optimal
conditional mean between them.

Everything is numpy but ``compute_real_anchors`` and
``compute_real_levels``, which featurize the corpus through the port's
``TextMelDataset`` on ``device`` (the card unless ``device="cpu"`` is
passed): there every wav goes through the mel kernel once.
"""

import numpy as np

from gantron_tpu_torch.data.toy import HIBAND_LO_HZ


def band_channels(hp, lo_hz: float, hi_hz: float = None) -> np.ndarray:
    """Indices of mel channels whose center frequency is in
    [``lo_hz``, ``hi_hz``) (``hi_hz=None`` = unbounded above). The composed
    corpus (data.toy.build_composed_corpus) scores its two hidden factors on
    disjoint bands through this selector."""
    from gantron_tpu_torch.audio.filters import hz_to_mel, mel_to_hz

    pts = mel_to_hz(np.linspace(hz_to_mel(hp.mel_fmin),
                                hz_to_mel(hp.mel_fmax),
                                hp.n_mel_channels + 2))
    centers = pts[1:-1]
    keep = centers >= lo_hz
    if hi_hz is not None:
        keep &= centers < hi_hz
    return np.nonzero(keep)[0]


def hiband_channels(hp, lo_hz: float = HIBAND_LO_HZ) -> np.ndarray:
    """Indices of mel channels whose center frequency is >= ``lo_hz``."""
    return band_channels(hp, lo_hz)


def hiband_level(mel: np.ndarray, channels: np.ndarray) -> float:
    """Mean log-mel level of ``channels`` over the voiced frames of one
    (n_mel, T) mel. Frames in the quietest 10% of total energy are dropped
    so attention hiccups / end-of-utterance decay don't dilute the level."""
    mel = np.asarray(mel)
    if mel.ndim == 3:
        mel = mel[0]
    frame_energy = mel.mean(axis=0)
    if mel.shape[1] >= 8:
        keep = frame_energy >= np.quantile(frame_energy, 0.10)
        mel = mel[:, keep]
    return float(mel[channels].mean())


def hiband_series(mel: np.ndarray, channels: np.ndarray) -> np.ndarray:
    """Per-frame high-band level series over the voiced frames of one
    (n_mel, T) mel (same voiced-frame rule as ``hiband_level``)."""
    mel = np.asarray(mel)
    if mel.ndim == 3:
        mel = mel[0]
    frame_energy = mel.mean(axis=0)
    if mel.shape[1] >= 8:
        keep = frame_energy >= np.quantile(frame_energy, 0.10)
        mel = mel[:, keep]
    return mel[channels].mean(axis=0)


def texture_stats(mels_with_lengths, channels: np.ndarray) -> dict:
    """Per-frame texture statistics for the stochastic-texture corpus study
    (data.toy.build_texture_corpus): how much does the high-band level move
    frame to frame WITHIN an utterance?

    A mean-regressed (MSE-optimal) generator outputs the constant
    conditional mean -> ``temporal_std`` near zero; the real corpus redraws
    the amplitude i.i.d. per frame -> a large, known spread. ``mels`` may be
    real training mels or generated samples.
    """
    stds, diffs, levels = [], [], []
    for mel, L in mels_with_lengths:
        mel = np.asarray(mel)
        if mel.ndim == 3:
            mel = mel[0]
        mel = mel[:, : max(int(L), 2)]
        s = hiband_series(mel, channels)
        if s.size >= 4:
            stds.append(float(s.std()))
            diffs.append(float(np.mean(np.abs(np.diff(s)))))
            levels.append(float(s.mean()))
    return {
        "n": len(stds),
        "temporal_std": float(np.mean(stds)) if stds else 0.0,
        "temporal_std_spread": float(np.std(stds)) if stds else 0.0,
        "frame_diff": float(np.mean(diffs)) if diffs else 0.0,
        "level_mean": float(np.mean(levels)) if levels else 0.0,
    }


def mode_anchor_levels(levels_by_mode) -> dict:
    """Real-corpus anchors: ``levels_by_mode`` maps mode (0/1) -> list of
    per-utterance high-band levels. Returns the two mode means plus the
    midpoint (the MSE-optimal conditional-mean prediction sits between the
    modes in linear-energy space; in the log domain the midpoint remains a
    sound "uncommitted" anchor because the two real clusters are narrow)."""
    lo = float(np.mean(levels_by_mode[0]))
    hi = float(np.mean(levels_by_mode[1]))
    return {
        "mode_lo": lo,
        "mode_hi": hi,
        "midpoint": (lo + hi) / 2,
        "halfgap": abs(hi - lo) / 2,
        "spread_lo": float(np.std(levels_by_mode[0])),
        "spread_hi": float(np.std(levels_by_mode[1])),
    }


def compute_real_anchors(train_list, wav_dir, modes, hp,
                         channels=None, device="cuda") -> dict:
    """Real-mode anchors from the training mels via the SAME cached
    extraction the run trains on (TextMelDataset.get_mel). One definition
    shared by gan_mode_study.py and mode_attribution.py's --probe fallback
    so probe artifacts can never silently use a diverged anchor rule.
    ``channels`` overrides the default >=5 kHz band (the composed corpus
    anchors its mode bit on the [3.9, 4.9] kHz band instead)."""
    import os

    from gantron_tpu_torch.data.dataset import TextMelDataset

    ds = TextMelDataset([train_list], hp, wav_dir, device=device)
    if channels is None:
        channels = hiband_channels(hp)
    levels_by_mode = {0: [], 1: []}
    with open(train_list) as f:
        names = [line.split("|")[0] for line in f if line.strip()]
    for name in names:
        mel = ds.get_mel(os.path.join(wav_dir, name))
        levels_by_mode[modes[name]].append(hiband_level(mel, channels))
    return mode_anchor_levels(levels_by_mode)


def attribution_grid_stats(levels: np.ndarray, midpoint: float) -> dict:
    """Noise-vs-dropout attribution statistics on an (N styles, M dropout)
    grid of scalar mode levels (one decode each, same text).

    Under "dropout decides, the latent is ignored" the per-style hi counts
    are Binomial(M, frac_hi); a latent-driven mode split overdisperses them
    (``per_style_chi2_p`` < ~0.05 = real per-style structure). One
    definition shared by scripts/mode_attribution.py and
    scripts/gan_composed_study.py."""
    levels = np.asarray(levels, np.float64)
    N, M = levels.shape
    mode = levels > midpoint  # True = hi mode
    hi_per_style = mode.sum(axis=1)
    majority = np.maximum(hi_per_style, M - hi_per_style) / M
    frac_hi = float(mode.mean())
    chance_floor = max(frac_hi, 1 - frac_hi)
    if 0.0 < frac_hi < 1.0:
        from scipy import stats
        chi2 = float(((hi_per_style - M * frac_hi) ** 2
                      / (M * frac_hi * (1 - frac_hi))).sum())
        chi2_p = float(1 - stats.chi2.cdf(chi2, df=N - 1))
    else:
        chi2, chi2_p = 0.0, 1.0  # degenerate grid (fully collapsed)
    return {
        "n_styles": N,
        "n_dropout": M,
        "grid_frac_hi": round(frac_hi, 4),
        "within_noise_consistency": round(float(majority.mean()), 4),
        "consistency_chance_floor": round(chance_floor, 4),
        "styles_majority_hi": int((hi_per_style > M / 2).sum()),
        "styles_majority_lo": int(N - (hi_per_style > M / 2).sum()),
        "per_style_chi2": round(chi2, 2),
        "per_style_chi2_p": round(chi2_p, 4),
        "hi_fraction_std_across_styles":
            round(float(mode.mean(axis=1).std()), 4),
        "hi_fraction_std_across_dropout":
            round(float(mode.mean(axis=0).std()), 4),
        "per_style_hi_counts": hi_per_style.tolist(),
        "level_grid": np.round(levels, 3).tolist(),
    }


def joint_mode_grid(levels_a: np.ndarray, levels_b: np.ndarray,
                    mid_a: float, mid_b: float) -> np.ndarray:
    """Two same-shaped grids of per-band scalar levels -> joint mode ids
    ``2*(a > mid_a) + (b > mid_b)`` in [0, 4). The factorial corpus's four
    joint modes, keyed (bitA, bitB) -> 0:(0,0) 1:(0,1) 2:(1,0) 3:(1,1)."""
    a = np.asarray(levels_a, np.float64) > mid_a
    b = np.asarray(levels_b, np.float64) > mid_b
    return (2 * a + b).astype(np.int64)


def attribution_grid_stats_multi(modes: np.ndarray, n_modes: int) -> dict:
    """K-way generalization of ``attribution_grid_stats`` for an
    (N styles, M dropout) grid of DISCRETE mode ids in [0, n_modes) —
    the factorial study's joint-mode attribution. Under "dropout decides,
    the latent is ignored" each style's draws are i.i.d. multinomial over
    the grid's marginal mode frequencies; latent-driven structure shows as
    a style x mode contingency chi^2 (df (N-1)(K'-1) over the K' modes
    present in the grid)."""
    modes = np.asarray(modes)
    N, M = modes.shape
    counts = np.stack([(modes == k).sum(axis=1) for k in range(n_modes)],
                      axis=1)  # (N, K)
    p = counts.sum(axis=0) / float(N * M)
    majority = counts.max(axis=1) / M
    present = p > 0
    k_present = int(present.sum())
    if k_present >= 2:
        from scipy import stats
        e = M * p[present]
        chi2 = float(((counts[:, present] - e[None, :]) ** 2 / e).sum())
        chi2_p = float(1 - stats.chi2.cdf(chi2,
                                          df=(N - 1) * (k_present - 1)))
    else:
        chi2, chi2_p = 0.0, 1.0  # degenerate grid (fully collapsed)
    majority_mode = counts.argmax(axis=1)
    return {
        "n_styles": N,
        "n_dropout": M,
        "n_modes": n_modes,
        "grid_mode_freqs": [round(float(v), 4) for v in p],
        "modes_present": k_present,
        "within_noise_consistency": round(float(majority.mean()), 4),
        "consistency_chance_floor": round(float(p.max()), 4),
        "styles_majority_per_mode":
            [int((majority_mode == k).sum()) for k in range(n_modes)],
        "per_style_chi2": round(chi2, 2),
        "per_style_chi2_p": round(chi2_p, 4),
        "per_style_mode_counts": counts.tolist(),
    }


def code_binding_stats(levels: np.ndarray, code_grid: np.ndarray) -> dict:
    """Disentanglement of a multi-dim discrete code against multi-band
    levels.

    ``levels``: (n_cells, S, n_bands) per-band scalar levels of S decodes
    of each code cell; ``code_grid``: (n_cells, code_dims) int code levels
    per cell (every trained cell enumerated once). ``binding[d][b]`` =
    range over code-dim-d levels of the conditional mean of band b
    (marginalizing the other dims and draws) — how much dim d moves band b.
    ``assignment[d]`` = the band dim d moves most; ``modularity`` = mean
    over dims of (top effect - runner-up) / (top + runner-up): 1 = each
    dim moves exactly one band, 0 = moves two bands equally.
    ``bands_bound`` counts DISTINCT assigned bands — a factorized code must
    also be injective (two dims binding the same band is entanglement the
    per-dim modularity cannot see)."""
    levels = np.asarray(levels, np.float64)
    code_grid = np.asarray(code_grid)
    n_cells, S, n_bands = levels.shape
    code_dims = code_grid.shape[1]
    binding = np.zeros((code_dims, n_bands))
    for d in range(code_dims):
        cond = []
        for lvl in np.unique(code_grid[:, d]):
            sel = code_grid[:, d] == lvl
            cond.append(levels[sel].mean(axis=(0, 1)))  # (n_bands,)
        cond = np.stack(cond)
        binding[d] = cond.max(axis=0) - cond.min(axis=0)
    assignment = binding.argmax(axis=1)
    mod = []
    for d in range(code_dims):
        eff = np.sort(binding[d])[::-1]
        top, second = eff[0], (eff[1] if n_bands > 1 else 0.0)
        mod.append((top - second) / max(top + second, 1e-9))
    return {
        "binding_matrix": np.round(binding, 4).tolist(),
        "assignment": assignment.tolist(),
        "bands_bound": int(len(set(assignment.tolist()))),
        "modularity": round(float(np.mean(mod)), 4),
    }


def code_mode_coverage(cell_modes: np.ndarray, n_modes: int) -> dict:
    """Can the trained code REACH every joint mode? ``cell_modes``:
    (n_cells, S) joint mode ids of S decodes of each code cell. Each cell
    votes its majority mode; coverage = fraction of the n_modes joint
    modes some cell's majority reaches. ``cell_consistency`` = mean
    majority fraction (how committed each cell is to its mode)."""
    cell_modes = np.asarray(cell_modes)
    n_cells, S = cell_modes.shape
    counts = np.stack([(cell_modes == k).sum(axis=1)
                       for k in range(n_modes)], axis=1)
    majority_mode = counts.argmax(axis=1)
    return {
        "cell_majority_modes": majority_mode.tolist(),
        "modes_reached": int(len(set(majority_mode.tolist()))),
        "coverage": round(len(set(majority_mode.tolist())) / n_modes, 4),
        "cell_consistency":
            round(float((counts.max(axis=1) / S).mean()), 4),
        "cell_mode_counts": counts.tolist(),
    }


def commitment_stats(gen_levels, anchors: dict) -> dict:
    """Score generated samples against the real-mode anchors.

    ``commitment`` per sample = |level - midpoint| / halfgap, clipped to
    [0, 1.5]: 0 = the blurred conditional mean, ~1 = sitting on a real
    mode. ``frac_near_mode`` = fraction within half a halfgap of either
    mode. ``frac_hi`` = fraction assigned to the textured mode (a
    mode-committed one-to-many generator should split these across draws;
    a mean-regressed generator puts everything near the midpoint)."""
    g = np.asarray(gen_levels, np.float64)
    mid, half = anchors["midpoint"], max(anchors["halfgap"], 1e-9)
    c = np.clip(np.abs(g - mid) / half, 0.0, 1.5)
    d_lo = np.abs(g - anchors["mode_lo"])
    d_hi = np.abs(g - anchors["mode_hi"])
    near = np.minimum(d_lo, d_hi) <= 0.5 * half
    return {
        "n": int(g.size),
        "mean_commitment": float(c.mean()),
        "frac_near_mode": float(near.mean()),
        "frac_hi": float((g > mid).mean()),
        "level_mean": float(g.mean()),
        "level_std": float(g.std()),
        "levels": [round(float(v), 3) for v in g],
    }


def compute_real_levels(train_list, wav_dir, levels, hp,
                        channels=None, device="cuda") -> dict:
    """Real-utterance transfer curve for a CONTINUOUS hidden factor
    (data.toy.build_leveled_corpus): per-utterance (u, measured band
    level) through the SAME cached extraction the run trains on, plus the
    instrument check (Spearman u vs level — the corpus is only a valid
    instrument if the real curve is monotone) and the real level range
    the control metric is normalized by."""
    import os

    from scipy import stats

    from gantron_tpu_torch.data.dataset import TextMelDataset

    ds = TextMelDataset([train_list], hp, wav_dir, device=device)
    if channels is None:
        channels = hiband_channels(hp)
    with open(train_list) as f:
        names = [line.split("|")[0] for line in f if line.strip()]
    u = np.array([levels[n] for n in names], np.float64)
    band = np.array([hiband_level(ds.get_mel(os.path.join(wav_dir, n)),
                                  channels) for n in names], np.float64)
    rho = stats.spearmanr(u, band)
    return {
        "n": int(u.size),
        "spearman": round(float(rho.statistic), 4),
        "spearman_p": float(rho.pvalue),
        "p5": round(float(np.percentile(band, 5)), 4),
        "p95": round(float(np.percentile(band, 95)), 4),
        "u": [round(float(v), 4) for v in u],
        "band_level": [round(float(v), 4) for v in band],
    }


def continuous_control_stats(code_values, levels, real_p5, real_p95,
                             n_perm: int = 10000, seed: int = 0) -> dict:
    """Does a CONTINUOUS code dim act as a monotone control knob?

    ``code_values``: (n_codes,) swept values of one code dim;
    ``levels``: (n_codes, S) measured band levels of S nuisance decodes
    per code value; ``real_p5``/``real_p95``: the real corpus's band-level
    range (compute_real_levels) the achieved control range is normalized
    by. Reports pooled Spearman rho (code value vs level over all
    n_codes*S decodes) with both the analytic and a permutation p-value
    (labels shuffled over the pooled decodes, fixed PRNG), the fraction of
    adjacent code pairs whose mean level increases (monotonicity), the
    achieved-vs-real range ratio, and between-code spread over mean
    within-code spread (the continuous analog of the discrete separation
    ratio)."""
    from scipy import stats

    code_values = np.asarray(code_values, np.float64)
    levels = np.asarray(levels, np.float64)
    n_codes, S = levels.shape
    pooled_c = np.repeat(code_values, S)
    pooled_l = levels.reshape(-1)
    rho = stats.spearmanr(pooled_c, pooled_l)
    r = float(rho.statistic)
    rng = np.random.RandomState(seed)
    perm = np.array([
        stats.spearmanr(pooled_c, rng.permutation(pooled_l)).statistic
        for _ in range(n_perm)])
    p_perm = float((np.abs(perm) >= abs(r)).mean())
    cell_means = levels.mean(axis=1)
    order = np.argsort(code_values)
    diffs = np.diff(cell_means[order])
    within = float(levels.std(axis=1).mean())
    between = float(cell_means.std())
    real_range = max(float(real_p95) - float(real_p5), 1e-9)
    return {
        "n_codes": int(n_codes),
        "n_draws": int(S),
        "spearman": round(r, 4),
        "spearman_p": float(rho.pvalue),
        "perm_p": p_perm,
        "n_perm": int(n_perm),
        "monotonicity": round(float((diffs > 0).mean()), 4),
        "range_achieved": round(float(cell_means.max() - cell_means.min()),
                                4),
        "range_real": round(real_range, 4),
        "range_coverage": round(
            float(cell_means.max() - cell_means.min()) / real_range, 4),
        "within_spread": round(within, 4),
        "between_spread": round(between, 4),
        "control_ratio": round(between / max(within, 1e-9), 4),
        "cell_means": [round(float(v), 4) for v in cell_means],
        "cell_stds": [round(float(v), 4)
                      for v in levels.std(axis=1)],
        "code_values": [round(float(v), 4) for v in code_values],
    }
