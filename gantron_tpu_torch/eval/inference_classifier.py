"""Classifier inference on wav files and folders (port of
gantron_tpu/eval/inference_classifier.py; reference: inference_classifier.py).

Features must match training: classifier-style dB mel, ``/80 + 1``
normalization (reference inference_classifier.py:64-70), sliding-window
averaged probabilities, SAVEE/CREMA-D label decoding from filenames. The
features are computed on the classifier's device.
"""

import os
import random

import numpy as np
import torch.nn.functional as F

from gantron_tpu_torch.audio.mel import PowerMelDB
from gantron_tpu_torch.data.wav import load_wav
from gantron_tpu_torch.models.classifier import sliding_window_probs

ID_TO_EMOTION = {0: "Neutral", 1: "Angry", 2: "Happy", 3: "Sad",
                 4: "Fearful"}
FROM_IDS_SAVEE = {"a": "Angry", "f": "Fearful", "h": "Happy", "n": "Neutral",
                  "sa": "Sad"}
FROM_IDS_CREMAD = {"NEU": "Neutral", "ANG": "Angry", "HAP": "Happy",
                   "SAD": "Sad", "FEA": "Fearful"}


def _features(path, hp, sr=22050, device="cuda"):
    """(n_mel, max(T, n_frames)) normalized dB mel of the wav at ``path``,
    on ``device``."""
    mel_fn = PowerMelDB(sr, hp.n_ftt, hp.hop_length, hp.n_mel_channels,
                        device=device)
    mel = mel_fn(load_wav(path, sr)[None])[0] / 80.0 + 1.0
    if mel.shape[1] < hp.n_frames:
        mel = F.pad(mel, (0, hp.n_frames - mel.shape[1]))
    return mel


def inference_from_path(model, path, hp, sr=22050):
    """(probabilities averaged over the windows as numpy, predicted emotion
    name) of the port ``Classifier`` ``model`` for the wav at ``path``."""
    mel = _features(path, hp, sr, model.device)
    probs = sliding_window_probs(model.eval().predict, mel[None],
                                 hp.n_frames)[0].cpu().numpy()
    return probs, ID_TO_EMOTION[int(np.argmax(probs))]


def decode_ground_truth(filename, dataset):
    if dataset == "SAVEE":
        key = "sa" if filename[:2] == "sa" else filename[0]
        return FROM_IDS_SAVEE.get(key)
    if dataset == "CREMA-D":
        return FROM_IDS_CREMAD.get(filename[9:12])
    raise ValueError(f"Dataset not supported: {dataset}")


def inference_folder(model, folder, dataset, hp, sr=22050, max_files=500,
                     seed=0, verbose=True):
    """Folder-level accuracy (percent) against filename-encoded labels."""
    names = [p for p in os.listdir(folder) if p.endswith(".wav")]
    if len(names) > max_files:
        names = random.Random(seed).sample(names, max_files)
    files = correct = 0
    for path in names:
        gt = decode_ground_truth(path, dataset)
        if gt is None:
            continue
        files += 1
        probs, pred = inference_from_path(model, os.path.join(folder, path),
                                          hp, sr)
        if verbose:
            pretty = ", ".join(f"{v:.2f}" for v in probs)
            print(f"Inferred emotion for {path} is: {pred} -> {pretty}")
        if pred == gt:
            correct += 1
    acc = 100.0 * correct / max(files, 1)
    if verbose:
        print(f"Achieved accuracy of {acc:.2f}%")
    return acc
