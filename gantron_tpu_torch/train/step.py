"""Training step types (port of gantron_tpu/train/step.py; so far only the
batch that ``data.dataset.collate`` returns)."""

from typing import NamedTuple

import numpy as np


class Batch(NamedTuple):
    """One padded, bucketed batch of numpy arrays (layout mirrors reference
    TextMelCollate output, data_utils.py:88-131)."""

    text: np.ndarray            # (B, T_in) int32
    text_lengths: np.ndarray    # (B,) int32
    mels: np.ndarray            # (B, n_mel, T_out) float32
    gate: np.ndarray            # (B, T_out) float32
    speaker: np.ndarray         # (B,) int32
    emotions: np.ndarray        # (B, 5) float32
    output_lengths: np.ndarray  # (B,) int32
