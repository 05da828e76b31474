"""Forced-style/emotion sample generation and the mode-collapse probe (port
of part of gantron_tpu/eval/sampling.py; reference: inference_samples.py).

``force_style_emotions`` generates ``n_groups`` groups of samples where the
emotion vector and/or the noise style is held fixed per group, saving one
``.npy`` mel per sample and counting decoder-cap hits
(reference inference_samples.py:42-126). Each group's samples run as one
batched decode. Random draws come from a ``torch.Generator`` where the JAX
package takes a key; the draws differ, the distributions do not.

The identification machinery's serving and probing side follows:
``coded_style`` pins a trained code level, ``attribution_level_grid``
decodes the noise-vs-dropout grid, and ``latent_separation`` (with
``separation_grid_styles``, ``probe_grid_shape`` and
``code_separation_ratio``) is the training loop's collapse sensor.
"""

import os

import numpy as np
import torch

from gantron_tpu_torch.utils.device import derive_seed
from gantron_tpu_torch.utils.device import generator as seeded_generator

PREDEFINED_EMOTIONS = np.array([
    # [Neutral, Angry, Happy, Sad, Fearful]
    [0.6, 0, 0, 0, 0],
    [0, 0.7, 0, 0, 0],
    [0, 0, 0.5, 0, 0],
    [0, 0, 0, 0.8, 0],
    [0, 0, 0, 0, 0.75],
], np.float32)

INT_EMOTIONS = np.array([
    [1, 0, 0, 0, 0], [0, 1, 0, 0, 0], [0, 0, 1, 0, 0],
    [0, 0, 0, 1, 0], [0, 0, 0, 0, 1], [0, 0, 0, 0, 0],
], np.float32)


def _uniform(shape, generator):
    """float32 numpy U[0, 1) draws from ``generator`` (on its device)."""
    return torch.rand(shape, generator=generator,
                      device=generator.device).cpu().numpy()


def group_emotions(n_groups, int_emotions, predefined, generator):
    """Per-group emotion vectors (reference inference_samples.py:70-93)."""
    if int_emotions:
        if n_groups > 6:
            raise ValueError("only 6 integer emotion combinations exist")
        return INT_EMOTIONS[:n_groups].copy()
    if predefined:
        extra = _uniform((max(n_groups - 5, 0), 5), generator)
        return np.concatenate([PREDEFINED_EMOTIONS[:min(n_groups, 5)],
                               extra], axis=0)[:n_groups]
    return _uniform((n_groups, 5), generator)


def _sample_name(g, i, emotions, force_emotions, force_style, simple_name):
    if simple_name:
        name = f"{g}-{i}"
        if emotions is not None:
            name += "-" + ",".join(str(round(float(v), 2))
                                   for v in emotions[g])
        return name
    name = ""
    if force_emotions:
        name += f"emotion-{g}-"
    if force_style:
        name += f"style-{g}-"
    if not name:
        # With neither force flag the reference names every group's samples
        # identically and groups overwrite each other
        # (inference_samples.py:118-123); keep the group prefix so all
        # n_groups*B mels survive.
        name = f"group-{g}-"
    return name + f"{i}"


def force_style_emotions(model, input_sequence, output_path, speaker=None,
                         force_emotions=True, force_style=True,
                         style_shape=None, n_groups=6, n_samples_styles=20,
                         simple_name=False, int_emotions=False,
                         predefined=False, max_decoder_steps=500,
                         generator=None, styles=None):
    """Generate and save grouped samples with the port's ``Tacotron2``
    ``model``; returns the number of samples that hit the decoder cap (the
    'generation error' count). ``input_sequence``: (1, T_in) ids.
    ``styles``: optional (n_groups, 1, noise_size) per-group styles in place
    of the draws from ``generator`` (seed 0 on the model's device when
    None), which also draws the emotions and the decode's dropout."""
    os.makedirs(output_path, exist_ok=True)
    device = model.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    ids = torch.as_tensor(np.asarray(input_sequence), dtype=torch.long,
                          device=device)
    noise_size = style_shape[1] if style_shape else 0

    emotions = (group_emotions(n_groups, int_emotions, predefined, generator)
                if force_emotions else None)
    if force_style and styles is None:
        styles = _uniform((n_groups, 1, noise_size), generator)
    if not force_style:
        styles = None

    B = n_samples_styles
    text_batch = ids.expand(B, ids.shape[1])
    speaker_batch = (torch.full((B,), int(speaker), dtype=torch.long,
                                device=device)
                     if speaker is not None else None)

    max_decoder_steps_reached = 0
    for g in range(n_groups):
        emotion = (torch.as_tensor(emotions[g], device=device).expand(B, 5)
                   if emotions is not None else None)
        style = (torch.tensor(np.asarray(styles[g]), dtype=torch.float32,
                              device=device).expand(B, 1, noise_size)
                 if styles is not None else None)
        out = model.infer(text_batch, style, emotion, speaker_batch,
                          max_decoder_steps, generator=generator,
                          noise_generator=generator)
        mel_post = out[1].cpu().numpy()  # (B, n_mel, S)
        lengths = out[4].cpu().numpy()
        for i in range(B):
            L = int(lengths[i])
            if L >= max_decoder_steps:
                max_decoder_steps_reached += 1
            name = _sample_name(g, i, emotions, force_emotions, force_style,
                                simple_name)
            np.save(os.path.join(output_path, f"{name}.npy"),
                    mel_post[i, :, :L])
    return max_decoder_steps_reached


def random_style(model, input_sequence, n_samples, speaker=None,
                 generator=None, max_decoder_steps=500):
    """Free sampling with random style/emotions per sample
    (reference inference_samples.py:129-143): one decode of ``n_samples``
    rows whose style (and emotion) draws and dropout come from
    ``generator`` (seed 0 on the model's device when None). Returns (mels
    (B, n_mel, S), lengths (B,)) as numpy."""
    device = model.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    ids = torch.as_tensor(np.asarray(input_sequence), dtype=torch.long,
                          device=device)
    B = n_samples
    speaker_batch = (torch.full((B,), int(speaker), dtype=torch.long,
                                device=device)
                     if speaker is not None else None)
    out = model.infer(ids.expand(B, ids.shape[1]), None, None,
                      speaker_batch, max_decoder_steps, generator=generator,
                      noise_generator=generator)
    return out[1].cpu().numpy(), out[4].cpu().numpy()


def pairwise_sample_distance(mels, lengths):
    """Mean pairwise masked L1 distance between free-running samples of the
    SAME text — the mode-collapse detector behind
    ``validation_sample_diversity`` (config.py). Per pair, the distance is
    averaged over the pair's max emitted length: frames where one decode
    has stopped and the other hasn't still count, but post-stop zero padding
    common to both does not dilute the statistic. ~0 across independent
    noise/dropout draws = the sampler has collapsed to one output — a
    failure teacher-forced validation loss cannot see, because it conditions
    every frame on real history.

    mels: (B, n_mels, T) array; lengths: (B,) emitted frame counts.
    Returns a float (0.0 when B < 2).
    """
    mels = np.asarray(mels, np.float32)
    lengths = np.asarray(lengths)
    B, n_mels, T = mels.shape
    dists = []
    for i in range(B):
        for j in range(i + 1, B):
            pair_len = int(max(lengths[i], lengths[j], 1))
            d = np.abs(mels[i, :, :pair_len] - mels[j, :, :pair_len])
            dists.append(d.sum() / (n_mels * pair_len))
    return float(np.mean(dists)) if dists else 0.0


def coded_style(generator, n_samples, noise_size, code, code_dims=1,
                code_levels=2, nuisance=None):
    """Style batch (n_samples, 1, noise_size) with the identifiable code
    (the first ``code_dims`` dims) pinned to the trained grid level
    ``(code + 0.5) / code_levels`` and the other (nuisance) dims drawn
    U[0, 1) from ``generator`` (or given as ``nuisance``, of the style's
    shape, whose code dims are overwritten). Pass it as ``style=`` to
    ``Tacotron2.infer`` or ``Synthesizer.infer_mel`` to generate a chosen
    mode; other draws give other utterances within that mode.

    ``code``: one int level in [0, code_levels), broadcast to every sample
    and code dim; ``(n_samples,)`` per-sample levels (every code dim of a
    sample at its level); or ``(code_dims,)`` / ``(n_samples, code_dims)``
    per-dim levels, the only forms that reach the off-diagonal cells of a
    multi-dim code. ``code_dims``/``code_levels`` must match training
    (config.py ``style_code_dims``/``style_code_levels``)."""
    if not 0 < code_dims <= noise_size:
        raise ValueError(
            f"code_dims={code_dims} must be in [1, noise_size={noise_size}]"
            " (the code is a prefix of the style vector)")
    if code_levels < 2:
        raise ValueError(
            f"code_levels={code_levels}: a pinnable code needs >= 2 levels")
    code = torch.as_tensor(np.asarray(code), dtype=torch.long)
    if code.dim() == 0:
        code = code.expand(n_samples, code_dims)
    elif tuple(code.shape) == (n_samples,) and code_dims != n_samples:
        code = code[:, None].expand(n_samples, code_dims)
    elif tuple(code.shape) == (code_dims,):
        code = code[None, :].expand(n_samples, code_dims)
    if tuple(code.shape) != (n_samples, code_dims):
        raise ValueError(
            f"code shape {tuple(code.shape)} is none of (), ({n_samples},), "
            f"({code_dims},), ({n_samples}, {code_dims}): pass one level, "
            "per-sample levels, per-dim levels, or the full grid")
    if nuisance is None:
        style = _rand((n_samples, 1, noise_size), generator)
    else:
        style = torch.as_tensor(nuisance, dtype=torch.float32).clone()
    style[:, 0, :code_dims] = ((code.float() + 0.5) / code_levels).to(
        style.device)
    return style


def _rand(shape, generator):
    return torch.rand(shape, generator=generator, device=generator.device)


def attribution_styles(hp, n_styles, seed=0, device="cpu"):
    """The (n_styles, 1, noise_size) styles of ``attribution_level_grid``'s
    rows: U[0, 1) from seed ``(100 + seed)`` on ``device`` (the studies read
    each row's code dims from them)."""
    return _rand((n_styles, 1, hp.noise_size),
                 seeded_generator(device, derive_seed(100 + seed)))


def attribution_level_grid(model, hp, input_sequence, channels, n_styles,
                           n_dropout, seed=0, max_decoder_steps=None,
                           styles=None):
    """(N styles) x (M dropout streams) grid of scalar band levels of one
    text: the decode half of the noise-vs-dropout attribution instrument
    (``mode_study.attribution_grid_stats`` scores it). Cell (i, j) is one
    free-running decode of ``model`` with style i (drawn U[0, 1) from seed
    ``(100 + seed)`` on the model's device, or ``styles`` (N, 1, noise))
    and prenet dropout stream j (seed ``(100 + seed, j)``); each of the M
    decodes runs the N styles as one batch. ``channels``: one mel-channel
    index array -> (N, M); or a list/tuple of B arrays -> (N, M, B), every
    band scored on the same decodes."""
    from gantron_tpu_torch.eval.mode_study import hiband_level

    bands = (list(channels) if isinstance(channels, (list, tuple))
             else [channels])
    N, M = n_styles, n_dropout
    device = model.device
    max_steps = max_decoder_steps or hp.max_decoder_steps
    ids = torch.as_tensor(np.asarray(input_sequence), dtype=torch.long,
                          device=device)
    text = ids.expand(N, ids.shape[1])
    if styles is None:
        styles = attribution_styles(hp, N, seed, device)
    styles = torch.as_tensor(styles, dtype=torch.float32).to(device)
    levels = np.zeros((N, M, len(bands)))
    for j in range(M):
        out = model.infer(text, styles, None, None, max_steps,
                          generator=seeded_generator(
                              device, derive_seed(100 + seed, j)))
        mels, lens = out[1].cpu().numpy(), out[4].cpu().numpy()
        for i in range(N):
            m = mels[i, :, : max(int(lens[i]), 2)]
            for b, ch in enumerate(bands):
                levels[i, j, b] = hiband_level(m, ch)
    if not isinstance(channels, (list, tuple)):
        return levels[:, :, 0]
    return levels


def _masked_l1(mels, lengths, i, j):
    """Masked per-frame L1 between grid rows i and j (the
    pairwise_sample_distance pair metric)."""
    n_mels = mels.shape[1]
    pair_len = int(max(lengths[i], lengths[j], 1))
    d = np.abs(mels[i, :, :pair_len] - mels[j, :, :pair_len])
    return float(d.sum() / (n_mels * pair_len))


def code_separation_ratio(mels, lengths, n_levels, n_draws):
    """Latent-collapse sensor: between-code / within-code distance ratio on
    a LEVEL-MAJOR decode grid of one text (row ``l * n_draws + s`` is latent
    level ``l`` under nuisance draw ``s``, as ``separation_grid_styles``
    builds it). BETWEEN pairs share the draw and differ in the level,
    WITHIN pairs share the level and differ in the draw. A latent that
    moves the output more than the nuisance does gives a ratio > 1; a
    collapsed one, <= ~1. Scale-free, unlike the raw spread, which prenet
    dropout keeps healthy-looking on collapsed checkpoints.

    mels: (n_levels * n_draws, n_mel, T); lengths: matching emitted
    counts."""
    mels = np.asarray(mels, np.float32)
    lengths = np.asarray(lengths)
    between, within = [], []
    for lv in range(n_levels):
        for s in range(n_draws):
            i = lv * n_draws + s
            for l2 in range(lv + 1, n_levels):
                between.append(_masked_l1(mels, lengths, i,
                                          l2 * n_draws + s))
            for s2 in range(s + 1, n_draws):
                within.append(_masked_l1(mels, lengths, i,
                                         lv * n_draws + s2))
    b = float(np.mean(between)) if between else 0.0
    w = float(np.mean(within)) if within else 0.0
    return b / max(w, 1e-8)


def separation_grid_styles(hp, n_levels, n_draws, generator, dim=None):
    """Level-major (n_levels * n_draws, 1, noise_size) style grid of the
    latent-separation probe, on ``generator``'s device; the one
    construction shared by the training loop's rescue sensor and offline
    calibration.

    Discrete-code configs (style_code_dims > 0, style_code_levels >= 2):
    the nuisance dims are drawn once a draw (first from ``generator``) and
    SHARED across levels; the code dims sweep the training grid
    ``(l + 0.5) / style_code_levels`` over ``n_levels`` levels spread over
    the trained range. ``dim``: sweep only code dim ``dim``; the other code
    dims are drawn from the grid once a draw (next from ``generator``) and
    shared across levels, so the between-level contrast isolates what that
    dim alone moves. Continuous configs: each level is one full random
    style shared across draws."""
    L, S = n_levels, n_draws
    code_dims = int(hp.style_code_dims or 0)
    code_levels = int(hp.style_code_levels or 0)
    if code_dims > 0 and code_levels >= 2:
        nuis = _rand((S, 1, hp.noise_size), generator)
        style = nuis.repeat(L, 1, 1)  # level-major
        lvls = np.round(np.linspace(0, code_levels - 1, L)).astype(np.int64)
        grid = ((torch.as_tensor(lvls, dtype=torch.float32) + 0.5)
                / code_levels).repeat_interleave(S).to(style.device)
        if dim is None:
            style[:, 0, :code_dims] = grid[:, None]
            return style
        if not 0 <= dim < code_dims:
            raise ValueError(f"dim={dim} not in [0, code_dims={code_dims})")
        other = (torch.randint(0, code_levels, (S, 1, code_dims),
                               generator=generator,
                               device=generator.device).float()
                 + 0.5) / code_levels
        style[:, :, :code_dims] = other.repeat(L, 1, 1)
        style[:, 0, dim] = grid
        return style
    per_level = _rand((L, 1, hp.noise_size), generator)
    return per_level.repeat_interleave(S, dim=0)


def probe_grid_shape(hp):
    """(n_levels, n_draws) of the latent-separation probe, sized so the
    grid costs about what the ``validation_sample_diversity``-row spread
    probe costs."""
    M = max(int(hp.validation_sample_diversity or 0), 4)
    code_levels = int(hp.style_code_levels or 0)
    if int(hp.style_code_dims or 0) > 0 and code_levels >= 2:
        L = min(code_levels, 4)
    else:
        L = 2
    return L, max(M // L, 2)


def latent_separation(model, hp, text, generator, dim=None, style=None):
    """Decode the separation grid of one text (``text``: (1, T) ids) with
    ``model`` and return ``(separation_ratio, spread)``. ``generator`` draws
    the grid's styles (``separation_grid_styles``; ``style`` in their
    place) and then the decode's prenet dropout; ``spread`` is
    ``pairwise_sample_distance`` over all rows. ``dim``: probe one code dim
    (the factor-aware form). The decode runs ``hp.max_decoder_steps``."""
    L, S = probe_grid_shape(hp)
    if style is None:
        style = separation_grid_styles(hp, L, S, generator, dim=dim)
    ids = torch.as_tensor(np.asarray(text), dtype=torch.long,
                          device=model.device)
    out = model.infer(ids.expand(L * S, ids.shape[1]), style, None, None,
                      hp.max_decoder_steps, generator=generator)
    mels, lengths = out[1].cpu().numpy(), out[4].cpu().numpy()
    return (code_separation_ratio(mels, lengths, L, S),
            pairwise_sample_distance(mels, lengths))
