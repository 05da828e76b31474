"""Dataset filelist parsers (reference: utils.py:47-184).

Formats:
  * LJSpeech: ``wavname|transcript``
  * VESUS:    ``relpath|transcript|speaker_id|e0,e1,e2,e3,e4``
  * CREMA-D / RAVDESS: ``wavname|e0,...,e4`` with emotion also encoded in the
    filename for 'intended' mode.
"""

import numpy as np

EMO_ID_TO_TEXT = {
    0: "Neutral", 1: "Anger", 2: "Happiness", 3: "Sadness", 4: "Fear",
}

VESUS_IDS = {
    "Neutral": [1, 0, 0, 0, 0],
    "Angry": [0, 1, 0, 0, 0],
    "Happy": [0, 0, 1, 0, 0],
    "Sad": [0, 0, 0, 1, 0],
    "Fearful": [0, 0, 0, 0, 1],
}

CREMA_IDS = {
    "NEU": [1, 0, 0, 0, 0], "ANG": [0, 1, 0, 0, 0], "HAP": [0, 0, 1, 0, 0],
    "SAD": [0, 0, 0, 1, 0], "FEA": [0, 0, 0, 0, 1],
}

RAVDESS_IDS = {
    "01": [1, 0, 0, 0, 0],  # neutral
    "05": [0, 1, 0, 0, 0],  # anger
    "03": [0, 0, 1, 0, 0],  # happiness
    "04": [0, 0, 0, 1, 0],  # sadness
    "06": [0, 0, 0, 0, 1],  # fear
}


def load_filepaths_and_text(filename, wavs_path, split="|"):
    out = []
    with open(filename, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue  # blank line would yield a textless 1-element row
            parts = line.strip().split(split)
            out.append([wavs_path + parts[0]] + parts[1:])
    return out


def _one_hot_of_max(values):
    labels = np.zeros(len(values))
    labels[int(np.argmax(values))] = 1
    return labels


def load_vesus(filename, wavs_path, split="|", use_labels="one",
               use_text=True):
    """Returns (filepaths_and_text, speakers, emotions); ``use_labels`` is
    'one' (argmax of votes), 'intended' (from the directory name) or 'multi'
    (annotator-weighted vector)."""
    speakers, emotions, filepaths_and_text = [], [], []
    with open(filename, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(split)
            filepath = wavs_path + parts[0]
            filepaths_and_text.append(
                [filepath, parts[1]] if use_text else filepath)
            speakers.append(int(parts[2]))
            if use_labels == "one":
                emotions.append(_one_hot_of_max(
                    [float(v) for v in parts[3].split(",")]))
            elif use_labels == "intended":
                emotions.append(VESUS_IDS[parts[0].split("/")[1]])
            else:
                emotions.append([float(v) for v in parts[3].split(",")])
    return filepaths_and_text, speakers, emotions


def load_cremad_ravdess(filename, wavs_path, use_labels, crema: bool):
    from_ids = CREMA_IDS if crema else RAVDESS_IDS
    filepaths, emotions = [], []
    with open(filename, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if use_labels == "one":
                emotions.append(_one_hot_of_max(
                    [float(v) for v in parts[1].split(",")]))
            elif use_labels == "intended":
                emo_id = (parts[0][9:12] if crema
                          else parts[0].split("-")[2])
                if emo_id not in from_ids:
                    continue
                emotions.append(from_ids[emo_id])
            else:
                emotions.append([float(v) for v in parts[1].split(",")])
            filepaths.append(wavs_path + parts[0])
    return filepaths, emotions


def calculate_emotions(labeled_emotions, labeled_intensities):
    """Annotator-weighted emotion intensities (reference utils.py:56-78)."""
    emotions = []
    n_labels = len(labeled_emotions)
    for emo_id in EMO_ID_TO_TEXT:
        idxs = np.where(labeled_emotions == emo_id)[0]
        if len(idxs) > 0:
            value = (labeled_intensities[idxs].mean() * len(idxs)
                     / (n_labels * 5))
        else:
            value = 0
        emotions.append(value)
    return emotions


def load_vesus_full(vesus_path):
    """Parse VESUS_Key.csv into (filepaths_and_text, speakers, emotions)."""
    import pandas as pd

    labels = pd.read_csv(vesus_path + "/Tools/VESUS_Key.csv", header=0)
    speakers, emotions, filepaths_and_text = [], [], []
    for row in labels.itertuples():
        speakers.append(row[2])
        labeled_emotions = np.array(
            [int(v) for v in row[8][1:-1].split(",")])
        labeled_intensities = np.array(
            [int(v) for v in row[9][1:-1].split(",")])
        emotions.append(calculate_emotions(labeled_emotions,
                                           labeled_intensities))
        filepaths_and_text.append(
            [vesus_path + "Audio/" + row[1], row[11].capitalize()])
    return filepaths_and_text, speakers, emotions
