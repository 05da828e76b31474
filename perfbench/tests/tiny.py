"""Tiny configurations and cells for the CPU tests: the benchmark's own
files with every width cut, so that a whole run (set-up, window, check)
takes seconds on the CPU."""

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_MODEL = dict(
    symbols_embedding_dim=16, encoder_embedding_dim=16, decoder_rnn_dim=24,
    prenet_dim=16, attention_rnn_dim=24, attention_dim=8,
    attention_location_n_filters=4, attention_location_kernel_size=5,
    postnet_embedding_dim=16, noise_size=8, speakers_embedding=4,
    discriminator_dim=16, discriminator_window=4, n_mel_channels=8,
    hop_length=4)
TINY_WAVEGLOW = dict(n_flows=4, n_group=4, n_early_every=2, n_early_size=1,
                     n_layers=2, n_channels=8, kernel_size=3,
                     upsample_kernel=8, upsample_stride=4)


def manifest():
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        return json.load(f)


def cells(traffic=None):
    """BENCHMARK.json's cells, or those of one traffic kind."""
    return [w["name"] for w in manifest()["workloads"]
            if traffic in (None, w["traffic"])]


def load(kind, name):
    with open(os.path.join(HERE, kind, name + ".json"),
              encoding="utf-8") as f:
        return json.load(f)


def tiny(cell_name, **params):
    """(manifest entry, cell, cfg) of a cell at tiny widths."""
    m = manifest()
    entry = next(w for w in m["workloads"] if w["name"] == cell_name)
    cell = copy.deepcopy(load("workloads", cell_name))
    cfg = copy.deepcopy(load("configs", entry["config"]))
    cfg["model"].update(TINY_MODEL)
    cfg["waveglow"] = dict(TINY_WAVEGLOW)
    cell["params"].update(params)
    return entry, cell, cfg, m
