"""Post-hoc calibration of a continuous style-code knob (port of
gantron_tpu/eval/calibration.py).

The continuous-control campaign (docs/TRAINING_EVIDENCE.md "Continuous
control") measured that an identified 1-dim continuous code is a
reproducibly MONOTONE knob for a hidden generative factor, but its GAIN
is seed-variable: over the training code box the achieved range covers
0.23-1.64x of the real factor range, while extrapolation shows the
code->level map stays live and monotone outside the box on 3/3 seeds.
The serving-time consequence: the knob needs a measured CALIBRATION
CURVE, not a raw code value — ask for a target level and invert the
curve, instead of guessing what code 0.7 means on this checkpoint.

This module provides that as a framework capability:

  * :func:`measure_knob` — the campaign's shared sweep protocol (fixed
    nuisance draws, code dim overwritten with swept values) run against
    any generator checkpoint, returning (code_values, levels).
  * :class:`KnobCalibration` — an isotonic (PAVA) fit of the measured
    code->level curve with a monotone inverse, range/coverage
    accounting, and JSON (de)serialization so a calibration ships next
    to its checkpoint.

The reference has no analogue (its noise vector is uncalibrated,
reference model.py:184-191, 273-279); this is what makes the latent a
usable control surface in production.

``pava``, ``KnobCalibration`` and ``VectorCalibration`` are numpy and equal
to the JAX package's. ``measure_knob`` decodes with the port's
``Tacotron2`` on the model's device (through the qmm kernel when the model
is int8). Unlike the JAX function, which draws one nuisance batch from
``PRNGKey(77 + seed)`` for every code dim, it seeds the nuisance draw from
``(seed, code_dim)``, so that the sweeps of different dims of one
checkpoint do not share their nuisance.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from gantron_tpu_torch.utils.device import derive_seed, generator

__all__ = ["KnobCalibration", "VectorCalibration", "measure_knob", "pava"]


def pava(y: np.ndarray, weights: np.ndarray = None) -> np.ndarray:
    """Pool-adjacent-violators: least-squares NON-DECREASING fit to y.

    Plain numpy (no sklearn dependency on the serving path). O(n) stack
    algorithm; ``weights`` defaults to uniform.
    """
    y = np.asarray(y, np.float64)
    w = (np.ones_like(y) if weights is None
         else np.asarray(weights, np.float64))
    if y.ndim != 1 or y.shape != w.shape:
        raise ValueError("pava expects matching 1-D arrays")
    # Each stack block is [mean, weight, count].
    blocks = []
    for yi, wi in zip(y, w):
        blocks.append([yi, wi, 1])
        while len(blocks) > 1 and blocks[-2][0] >= blocks[-1][0]:
            m2, w2, c2 = blocks.pop()
            m1, w1, c1 = blocks.pop()
            wt = w1 + w2
            blocks.append([(m1 * w1 + m2 * w2) / wt, wt, c1 + c2])
    out = np.empty_like(y)
    i = 0
    for m, _, c in blocks:
        out[i:i + c] = m
        i += c
    return out


class KnobCalibration:
    """Monotone code->level calibration for one style-code dimension.

    Fit from a measured sweep (``KnobCalibration.fit``); query with
    :meth:`level_for_code` / :meth:`code_for_level`. The fit detects the
    knob's sign (identification never orients the code — measured ρ of
    -0.996 and +0.978 are the same knob mirrored) and stores an
    isotonic fit in the detected direction.
    """

    def __init__(self, code_values, level_curve, sign: int,
                 raw_level_means=None, code_dim: int = 0):
        self.code_values = np.asarray(code_values, np.float64)
        self.level_curve = np.asarray(level_curve, np.float64)
        self.sign = int(sign)
        self.raw_level_means = (None if raw_level_means is None
                                else np.asarray(raw_level_means, np.float64))
        self.code_dim = int(code_dim)
        if self.code_values.ndim != 1 or np.any(
                np.diff(self.code_values) <= 0):
            raise ValueError("code_values must be strictly increasing 1-D")
        if self.level_curve.shape != self.code_values.shape:
            raise ValueError("level_curve/code_values shape mismatch")

    # -- construction ---------------------------------------------------

    @classmethod
    def fit(cls, code_values, levels, code_dim: int = 0):
        """``levels``: (n_codes,) cell means or (n_codes, n_draws) raw
        sweep levels (averaged over draws). Sign is chosen by the raw
        curve's net direction; the isotonic fit runs in that direction.
        """
        code_values = np.asarray(code_values, np.float64)
        levels = np.asarray(levels, np.float64)
        means = levels.mean(axis=1) if levels.ndim == 2 else levels
        order = np.argsort(code_values)
        code_values, means = code_values[order], means[order]
        # Net direction: Spearman-free and robust — compare the isotonic
        # fit residual both ways and keep the better one.
        up = pava(means)
        down = -pava(-means)
        sign = 1 if (np.abs(means - up).sum()
                     <= np.abs(means - down).sum()) else -1
        return cls(code_values, up if sign == 1 else down, sign,
                   raw_level_means=means, code_dim=code_dim)

    # -- queries --------------------------------------------------------

    @property
    def level_range(self):
        """(lo, hi) achieved level range of the fitted curve."""
        return float(self.level_curve.min()), float(self.level_curve.max())

    def coverage(self, real_lo: float, real_hi: float) -> float:
        """Achieved range / real factor range (the campaign metric)."""
        lo, hi = self.level_range
        return (hi - lo) / (real_hi - real_lo)

    def level_for_code(self, code):
        """Monotone interpolation of the fitted curve (clamped outside
        the measured code range)."""
        c = np.asarray(code, np.float64)
        if self.sign == 1:
            out = np.interp(c, self.code_values, self.level_curve)
        else:
            out = -np.interp(c, self.code_values, -self.level_curve)
        return float(out) if np.isscalar(code) or out.ndim == 0 else out

    def code_for_level(self, level):
        """Inverse of :meth:`level_for_code`.

        Levels outside the achieved range clamp to the nearest achieved
        endpoint's code — by construction the curve saturates there, so
        the clamp is the closest reachable operating point. A level that
        lands exactly on a flat (pooled) stretch inverts to the
        stretch's RIGHT edge in the monotone direction (np.interp's
        duplicate-knot behavior) — any code within the pool decodes to
        the same fitted level, so the choice is arbitrary but pinned
        here for reproducibility.
        """
        lv = np.asarray(level, np.float64)
        y = self.level_curve * self.sign  # non-decreasing
        out = np.interp(lv * self.sign, y, self.code_values)
        return float(out) if np.isscalar(level) or out.ndim == 0 else out

    def style_for_level(self, level, generator, noise_size: int,
                        nuisance=None):
        """(1, 1, noise_size) style: a U[0, 1) nuisance draw from
        ``generator`` (a ``torch.Generator``, on its device; or the given
        ``nuisance``) with the calibrated code dim pinned to
        :meth:`code_for_level`."""
        if nuisance is None:
            style = torch.rand((1, 1, noise_size), generator=generator,
                               device=generator.device)
        else:
            style = torch.as_tensor(nuisance, dtype=torch.float32) \
                .reshape(1, 1, noise_size).clone()
        style[0, 0, self.code_dim] = float(self.code_for_level(level))
        return style

    # -- (de)serialization ---------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "code_dim": self.code_dim,
            "sign": self.sign,
            "code_values": self.code_values.tolist(),
            "level_curve": self.level_curve.tolist(),
            "raw_level_means": (None if self.raw_level_means is None
                                else self.raw_level_means.tolist()),
        })

    @classmethod
    def from_json(cls, s: str):
        d = json.loads(s)
        return cls(d["code_values"], d["level_curve"], d["sign"],
                   raw_level_means=d.get("raw_level_means"),
                   code_dim=d.get("code_dim", 0))


def measure_knob(model, hp, text_ids, score_fn, code_values=None,
                 n_draws: int = 8, seed: int = 0, code_dim: int = 0,
                 max_steps=None, nuisance=None):
    """Sweep one code dim against shared nuisance draws; score decodes.

    The campaign's control-sweep protocol (gan_continuous_study.py): the
    nuisance style vector is drawn ONCE per draw slot and shared across
    every swept code value, so between-code differences are attributable
    to the code alone. All n_codes x n_draws rows run as one free-running
    decode of ``model`` (the port's ``Tacotron2``) on its device.
    ``score_fn(mel[:, :L]) -> float`` maps a trimmed decode (numpy) to the
    scalar being controlled (e.g. a band level via
    ``eval.mode_study.hiband_level``).

    The nuisance (n_draws, 1, noise_size) is drawn U[0, 1) from seed
    ``(77 + seed, code_dim)`` unless ``nuisance`` gives it; the prenet's
    dropout from seed ``(77 + seed, code_dim, 1)``.

    Returns ``(code_values, levels)`` with ``levels`` shaped
    (n_codes, n_draws) — feed directly to :meth:`KnobCalibration.fit`.
    """
    device = model.device
    code_values = (np.linspace(0.05, 0.95, 11) if code_values is None
                   else np.asarray(code_values, np.float64))
    n_codes = len(code_values)
    ids = np.asarray(text_ids, np.int64)
    if ids.ndim == 1:
        ids = ids[None]
    if nuisance is None:
        nuisance = torch.rand(
            (n_draws, 1, hp.noise_size), device=device,
            generator=generator(device, derive_seed(77 + seed, code_dim)))
    style = torch.as_tensor(nuisance, dtype=torch.float32).to(device) \
        .repeat(n_codes, 1, 1)
    style[:, 0, code_dim] = torch.as_tensor(
        code_values, dtype=torch.float32, device=device) \
        .repeat_interleave(n_draws)
    text = torch.as_tensor(ids, device=device).expand(n_codes * n_draws,
                                                      ids.shape[1])
    out = model.infer(text, style, None, None,
                      max_steps or hp.max_decoder_steps,
                      generator=generator(device,
                                          derive_seed(77 + seed, code_dim, 1)))
    mels, lengths = out[1].cpu().numpy(), out[4].cpu().numpy()
    scores = np.array([
        score_fn(mels[i, :, : max(int(lengths[i]), 2)])
        for i in range(mels.shape[0])])
    # A scalar score_fn gives (n_codes, n_draws); a vector one (e.g. one
    # level per band for VectorCalibration.fit) keeps its trailing axes.
    levels = scores.reshape(n_codes, n_draws, *scores.shape[1:])
    return code_values, levels


class VectorCalibration:
    """Linear unmix of an N-dim continuous code onto N measured factors.

    The vector study (scripts/gan_vector_study.py, TRAINING_EVIDENCE
    "Vector control") measured that a multi-dim continuous code
    identifies a product of continuous factors only UP TO ROTATION: every
    code dim is a significant knob (perm p < 0.05 on 3/3 seeds) but the
    code axes land rotated/entangled against the factor axes, and —
    unlike the discrete factorial case — training time does not
    axis-align them, because the identification objective is
    ~rotation-invariant over a continuous code box. The serving
    consequence mirrors the 1-dim gain problem (:class:`KnobCalibration`)
    one rank up: the control MATRIX must be measured and inverted.

    Model: ``levels ≈ c + M @ (code - 0.5)`` with M[b, d] the measured
    linear response of factor b to code dim d. Fit from per-dim sweeps
    (:func:`measure_knob` with a vector score_fn); invert with
    :meth:`code_for_levels` to get the code that REQUESTS a target level
    per factor — the rotated code becomes a panel of axis-aligned
    virtual knobs. The reference has no analogue (its noise vector is
    uncalibrated, reference model.py:184-191, 273-279).
    """

    def __init__(self, matrix, intercept, code_box=(0.05, 0.95)):
        self.matrix = np.asarray(matrix, np.float64)
        self.intercept = np.asarray(intercept, np.float64)
        n = self.intercept.size
        if self.matrix.shape != (n, n):
            raise ValueError("matrix must be (n_bands, n_dims) square")
        self.code_box = (float(code_box[0]), float(code_box[1]))

    # -- construction ---------------------------------------------------

    @classmethod
    def fit(cls, sweeps, code_box=(0.05, 0.95)):
        """``sweeps``: list over code dims of ``(code_values, levels)``
        from :func:`measure_knob` with a vector score_fn — ``levels``
        shaped (n_codes, n_draws, n_bands), every dim scored on the same
        bands. Least-squares line per (band, dim) on the draw-averaged
        cell means; the intercept is each band's fitted level at the
        code-box center, averaged over the per-dim sweeps."""
        n = len(sweeps)
        M = np.zeros((n, n))
        c_est = np.zeros((n, n))  # per-dim estimate of each band's center
        for d, (code_values, levels) in enumerate(sweeps):
            code_values = np.asarray(code_values, np.float64)
            means = np.asarray(levels, np.float64).mean(axis=1)  # (nc, nb)
            if means.ndim != 2 or means.shape[1] != n:
                raise ValueError(
                    "each sweep needs (n_codes, n_draws, n_bands) levels "
                    "with n_bands == number of sweeps")
            x = np.stack([code_values - 0.5,
                          np.ones_like(code_values)], axis=1)
            coef, *_ = np.linalg.lstsq(x, means, rcond=None)  # (2, nb)
            M[:, d] = coef[0]
            c_est[:, d] = coef[1]
        return cls(M, c_est.mean(axis=1), code_box=code_box)

    # -- queries --------------------------------------------------------

    @property
    def condition_number(self) -> float:
        return float(np.linalg.cond(self.matrix))

    def levels_for_code(self, code):
        """Forward model: predicted level per factor for a code vector."""
        code = np.asarray(code, np.float64)
        return self.intercept + self.matrix @ (code - 0.5)

    def code_for_levels(self, targets):
        """Solve for the code requesting ``targets`` (one level per
        factor). Returns ``(code, in_box)``: the solution clipped to the
        code box, and whether the UNCLIPPED solution was inside it (a
        clipped request is the nearest box point along each axis, not an
        exact hit — the caller decides whether that is acceptable)."""
        targets = np.asarray(targets, np.float64)
        x = np.linalg.solve(self.matrix, targets - self.intercept)
        code = 0.5 + x
        lo, hi = self.code_box
        clipped = np.clip(code, lo, hi)
        return clipped, bool(np.all((code >= lo) & (code <= hi)))

    # -- (de)serialization ---------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "matrix": self.matrix.tolist(),
            "intercept": self.intercept.tolist(),
            "code_box": list(self.code_box),
        })

    @classmethod
    def from_json(cls, s: str):
        d = json.loads(s)
        return cls(d["matrix"], d["intercept"],
                   code_box=tuple(d.get("code_box", (0.05, 0.95))))
