"""Forced-style/emotion sample generation and the mode-collapse probe (port
of part of gantron_tpu/eval/sampling.py; reference: inference_samples.py).

``force_style_emotions`` generates ``n_groups`` groups of samples where the
emotion vector and/or the noise style is held fixed per group, saving one
``.npy`` mel per sample and counting decoder-cap hits
(reference inference_samples.py:42-126). Each group's samples run as one
batched decode. Random draws come from a ``torch.Generator`` where the JAX
package takes a key; the draws differ, the distributions do not.

The rest of the JAX module (coded styles, latent separation, knob sweeps)
belongs to the identification machinery, which the port does not have yet.
"""

import os

import numpy as np
import torch

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
