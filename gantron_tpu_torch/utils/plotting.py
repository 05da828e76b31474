"""Validation media plots (copy of gantron_tpu/utils/plotting.py; reference:
plotting_utils.py).

Renders alignment heatmaps, predicted-vs-target mel pairs, and gate scatter
plots to numpy RGB arrays (and optionally PNG files) for the logger.
matplotlib is imported inside the functions, not with the module: it is
optional, and the training loop asks ``available()`` before it plots.
"""

import importlib.util

import numpy as np


def available() -> bool:
    """Whether matplotlib is installed."""
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _fig_to_numpy(plt, fig):
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
    plt.close(fig)
    return buf.copy()


def plot_alignment(alignment, info=None, save_path=None):
    """alignment: (T_in, T_out) attention matrix."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(alignment, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    xlabel = "Decoder timestep"
    if info is not None:
        xlabel += "\n\n" + info
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Encoder timestep")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return _fig_to_numpy(plt, fig)


def plot_spectrogram(pred_mel, ground_truth, save_path=None):
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(2, 1)
    ax1.imshow(pred_mel, origin="lower", aspect="auto")
    ax1.set_title("Generated mel spectrogram")
    im = ax2.imshow(ground_truth, origin="lower", aspect="auto")
    ax2.set_title("Ground truth mel spectrogram")
    fig.colorbar(im, ax=[ax1, ax2])
    ax2.set_xlabel("Frames")
    ax2.set_ylabel("Channels")
    if save_path:
        fig.savefig(save_path, dpi=150)
    return _fig_to_numpy(plt, fig)


def plot_gate_outputs(gate_targets, gate_outputs, save_path=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.scatter(range(len(gate_targets)), gate_targets, alpha=0.5,
               color="green", marker="+", s=1, label="target")
    ax.scatter(range(len(gate_outputs)), gate_outputs, alpha=0.5,
               color="red", marker=".", s=1, label="predicted")
    ax.set_xlabel("Frames (Green target, Red predicted)")
    ax.set_ylabel("Gate State")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return _fig_to_numpy(plt, fig)
