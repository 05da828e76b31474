"""Batched text -> waveform synthesis in a closed loop.

The cell's ``params``:

- ``corpus``: a file ``perfbench/data/<corpus>.jsonl`` of requests, each
  ``{"text", "ids"}`` and, for VESUS, ``"speaker"`` and ``"emotions"``;
- ``batch``: requests a batch; the seed orders the corpus (a new order each
  pass), and each batch takes the next ``batch`` requests;
- ``frames_per_char``, ``max_frames``: a request asks for
  min(max_frames, round(frames_per_char * characters)) frames;
- ``sigma``: WaveGlow's latent scale; ``gate_bias``: the gate readout's
  bias (the gate held off, so a batch decodes to its longest request);
- ``check_requests``: requests the check compares after the window.

A batch runs ``Tacotron2.infer`` over the padded texts for as many steps as
its longest request asks (no early exit) and ``WaveGlow.infer`` over the
padded mel; a request is credited with its own frames only. Every draw is
an input made from the seed: the style noise and WaveGlow's latents are
handed to the program; the prenet's dropout comes from a generator seeded
for the batch, whose draws the reference repeats.
"""

import json
import os
import time

import numpy as np
import torch

from perfbench import seeds, weights
from perfbench.laps import Laps
from perfbench.counts import flops
from perfbench.reference import tacotron2 as ref_taco
from perfbench.reference import waveglow as ref_wg
from perfbench.reference.precision import Precision

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


def load_corpus(name):
    with open(os.path.join(DATA, name + ".jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def request_frames(n_chars, params):
    return min(int(params["max_frames"]),
               int(round(params["frames_per_char"] * n_chars)))


class Batches:
    """The seed's stream of batches: (index, rows) in order."""

    def __init__(self, corpus, params, seed):
        self.corpus, self.params, self.seed = corpus, params, seed
        self.order, self.pass_, self.at = None, 0, 0

    def next_rows(self):
        B = int(self.params["batch"])
        rows = []
        while len(rows) < B:
            if self.order is None or self.at == len(self.order):
                rng = np.random.default_rng(
                    seeds.derive(self.seed, "order", self.pass_))
                self.order, self.at = rng.permutation(len(self.corpus)), 0
                self.pass_ += 1
            take = min(B - len(rows), len(self.order) - self.at)
            rows.extend(self.order[self.at:self.at + take].tolist())
            self.at += take
        return [self.corpus[i] for i in rows]


def batch_inputs(rows, params, m):
    """Host arrays of one batch: padded ids, lengths, frames, speakers,
    emotions."""
    lengths = np.array([len(r["ids"]) for r in rows], np.int64)
    ids = np.zeros((len(rows), lengths.max()), np.int64)
    for b, r in enumerate(rows):
        ids[b, :lengths[b]] = r["ids"]
    frames = np.array([request_frames(n, params) for n in lengths], np.int64)
    speaker = emotions = None
    if m["vesus"]:
        speaker = np.array([r["speaker"] for r in rows], np.int64)
        emotions = np.array([r["emotions"] for r in rows], np.float32)
    return ids, lengths, frames, speaker, emotions


def draws(cfg, seed, index, batch, n_frames, device):
    """The batch's style noise (B, 1, noise_size) and WaveGlow latents, in
    draw order from the batch's generator."""
    m = cfg["model"]
    g = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, "draws", index))
    style = (torch.rand((batch, 1, m["noise_size"]), generator=g,
                        device=device) if m["use_noise"] else None)
    z = [torch.randn((batch,) + s, generator=g, device=device)
         for s in ref_wg.z_shapes(cfg["waveglow"], n_frames)]
    return style, z


def prenet_generator(seed, index, device):
    return torch.Generator(device=device).manual_seed(
        seeds.derive(seed, "prenet", index))


class Traffic:
    """One cell of batched synthesis: ``setup``, ``unit`` (one batch),
    ``release`` and ``check``."""

    def __init__(self, cell, cfg, seed, device, trace, seconds):
        self.cfg, self.seed = cfg, seed
        self.device, self.trace = device, trace
        self.params, self.m = cell["params"], cfg["model"]
        self.spans = {"taco": [], "vocoder": []}
        self.count = dict(requests=0, failed=0, audio_s=0.0, flops=0)
        self.kept = []

    # -- set-up --------------------------------------------------------------
    def setup(self, program):
        """Weights from the seed, the program's models, and one batch of
        this cell's own traffic (the warm-up)."""
        m, dev = self.m, self.device
        lap = Laps(dev)
        g = torch.Generator(device=dev).manual_seed(
            seeds.derive(self.seed, "weights"))
        self.W = weights.tacotron2(m, g, dev, self.params.get("gate_bias"))
        self.P = weights.waveglow(self.cfg["waveglow"], g, dev,
                                  m["n_mel_channels"])
        lap("weights")
        self.model, self.waveglow = program.synthesizer(self.cfg, self.W,
                                                        self.P, dev)
        lap("program")
        self.hop_s = m["hop_length"] / m["sampling_rate"]
        self.batches = Batches(load_corpus(self.params["corpus"]),
                               self.params, self.seed)
        lap("corpus")
        self.index = -1
        self.unit(warmup=True)
        lap("warmup")
        self.setup_parts = lap.parts

    # -- one batch -----------------------------------------------------------
    def unit(self, warmup=False):
        m, dev, p = self.m, self.device, self.params
        self.index += 1
        i = self.index
        rows = self.batches.next_rows()
        ids, lengths, frames, speaker, emotions = batch_inputs(rows, p, m)
        B, S = len(rows), int(frames.max())
        style, z = draws(self.cfg, self.seed, i, B, S, dev)
        t_ids = torch.from_numpy(ids).to(dev)
        t_len = torch.from_numpy(lengths).to(dev)
        t_spk = torch.from_numpy(speaker).to(dev) if speaker is not None \
            else None
        t_emo = torch.from_numpy(emotions).to(dev) if emotions is not None \
            else None
        t0 = self._clock()
        out = self.model.infer(t_ids, style=style, emotions=t_emo,
                               speaker=t_spk, max_steps=S, early_exit=False,
                               text_lengths=t_len,
                               generator=prenet_generator(self.seed, i, dev))
        t1 = self._clock()
        audio = self.waveglow.infer(out[1], p["sigma"], z=z)
        bad = (~torch.isfinite(audio)).any(dim=1) \
            | (~torch.isfinite(out[1])).flatten(1).any(dim=1)
        n_bad = int(bad.sum())  # waits for the batch
        t2 = self._clock()
        self.last_unit = {"batch": B, "steps": S}
        if warmup:
            return
        if self.trace:
            self.spans["taco"].append((t1 - t0, S))
            self.spans["vocoder"].append((t2 - t1, B * S * self.hop_s))
        c = self.count
        c["requests"] += B
        c["failed"] += n_bad
        c["audio_s"] += float(frames.sum()) * self.hop_s
        c["flops"] += sum(flops.synthesis_flops(self.cfg, int(n), int(f))
                          for n, f in zip(lengths, frames))
        self._keep(i, rows, ids, lengths, frames, speaker, emotions, out,
                   audio)

    def _clock(self):
        """The host clock; in a traced run after the card's queue has
        drained, so that the spans hold their layer's work."""
        if self.trace and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _keep(self, i, rows, ids, lengths, frames, speaker, emotions, out,
              audio):
        """The batch's longest request and one drawn from the seed, for the
        check: their served frames, postnet mel and waveform."""
        rng = np.random.default_rng(seeds.derive(self.seed, "keep", i))
        picks = sorted({int(np.argmax(frames)),
                        int(rng.integers(len(rows)))})
        for r in picks:
            self.kept.append(dict(
                index=i, row=r, batch=len(rows), S=int(frames.max()),
                ids=ids[r, :lengths[r]], frames=int(frames[r]),
                speaker=None if speaker is None else int(speaker[r]),
                emotions=None if emotions is None else emotions[r],
                mel=out[0][r].clone(), mel_post=out[1][r].clone(),
                audio=audio[r].clone()))

    # -- what the window did -------------------------------------------------
    def end_to_end(self, window_s):
        return {"audio_s_per_s": self.count["audio_s"] / window_s}

    def attempted_failed(self):
        return self.count["requests"], self.count["failed"]

    def release(self):
        del self.model, self.waveglow
        self.model = self.waveglow = None

    # -- the check -----------------------------------------------------------
    def sample(self):
        """``check_requests`` of the kept requests, drawn from the seed, the
        longest among them always in."""
        n = int(self.params["check_requests"])
        kept = self.kept
        longest = max(range(len(kept)), key=lambda j: kept[j]["frames"])
        rng = np.random.default_rng(seeds.derive(self.seed, "sample"))
        rest = [j for j in rng.permutation(len(kept)).tolist()
                if j != longest][:n - 1]
        return [kept[j] for j in sorted([longest] + rest)]

    def check(self):
        """The reference over the sampled requests. Returns {name: gap}:
        ``mel_gap`` the decoder's frames, ``postnet_gap`` the postnet's mel,
        ``wav_gap`` the waveform; each the worst request's largest
        difference over its own frames, over the reference's largest
        magnitude there."""
        return compare(self.cfg, self.params, self.W, self.P, self.seed,
                       self.sample(), self.device)

    def controls(self, controls, faults=()):
        """{name: gaps} of each lower-precision control (the cell file's
        ``controls``: {name: precision}), the reference put in the
        program's place over the same requests, against the float32
        reference. Synthesis plants no faults here (the CPU tests do)."""
        return compare(self.cfg, self.params, self.W, self.P, self.seed,
                       self.sample(), self.device, controls)


def _pad_stack(tensors, length):
    return torch.stack([torch.nn.functional.pad(t, (0, length - t.shape[-1]))
                        for t in tensors])


def _worst(got, want, lengths):
    gap = 0.0
    for g, w, n in zip(got, want, lengths):
        g, w = g[..., :n].double(), w[..., :n].double()
        gap = max(gap, float((g - w).abs().max() / w.abs().max()))
    return gap


def compare(cfg, params, W, P, seed, reqs, device, controls=None):
    """The gaps of the served requests ``reqs`` from the reference's (see
    ``Traffic.check``); with ``controls``, of each control's from the
    reference's."""
    m = cfg["model"]
    n_chars = [len(r["ids"]) for r in reqs]
    ids = torch.zeros((len(reqs), max(n_chars)), dtype=torch.long)
    for j, r in enumerate(reqs):
        ids[j, :n_chars[j]] = torch.as_tensor(r["ids"])
    ids, lengths = ids.to(device), torch.as_tensor(n_chars, device=device)
    speaker = emotions = None
    if m["vesus"]:
        speaker = torch.as_tensor([r["speaker"] for r in reqs], device=device)
        emotions = torch.as_tensor(np.stack([r["emotions"] for r in reqs]),
                                   device=device)
    # The batches' draws again, from their seeds.
    sizes = {r["index"]: (r["batch"], r["S"]) for r in reqs}
    made = {i: draws(cfg, seed, i, B, S_i, device)
            for i, (B, S_i) in sizes.items()}
    style = (torch.cat([made[r["index"]][0][r["row"]][None] for r in reqs])
             if m["use_noise"] else None)
    S = max(r["S"] for r in reqs)
    served = _pad_stack([r["mel"].float() for r in reqs], S)
    served_post = _pad_stack([r["mel_post"].float() for r in reqs], S)

    def reference(prec):
        gens = {i: prenet_generator(seed, i, device) for i in sizes}

        def mask_draws(t):
            u = {i: [torch.rand((B, m["prenet_dim"]), generator=gens[i],
                                device=device) for _ in range(2)]
                 for i, (B, S_i) in sizes.items() if t < S_i}
            return tuple(torch.stack([u[r["index"]][k][r["row"]]
                                      if r["index"] in u else
                                      served.new_ones(m["prenet_dim"])
                                      for r in reqs]) for k in range(2))

        pred = ref_taco.decode_given_frames(
            W, m, ids, lengths, style, speaker, emotions, served, mask_draws,
            bits=prec.get("bits", cfg["precision"]["recurrence_bits"]),
            P_=Precision(prec.get("decoder", "float32")))
        post, wavs = [], []
        for j, r in enumerate(reqs):
            # Each request over its own batch's frames, as the program ran
            # it: a padded stack would carry the conv stack's edge inward.
            mel = served[j:j + 1, :, :r["S"]]
            with torch.no_grad():
                post.append((mel + ref_taco.postnet(
                    W, m, mel, P_=Precision(prec.get("postnet",
                                                     "float32"))))[0])
            z = [zi[r["row"]][None] for zi in made[r["index"]][1]]
            wavs.append(ref_wg.infer(
                cfg["waveglow"], P, served_post[j:j + 1, :, :r["S"]], z,
                params["sigma"],
                Precision(prec.get("waveglow", "float32")))[0])
        return pred, _pad_stack(post, S), wavs

    base = reference({})
    own = [r["frames"] for r in reqs]
    hop = m["hop_length"]

    def gaps(got):
        return {"mel_gap": _worst(got[0], base[0], own),
                "postnet_gap": _worst(got[1], base[1], own),
                "wav_gap": _worst(got[2], base[2], [f * hop for f in own])}

    if controls is not None:
        return {name: gaps(reference(prec))
                for name, prec in controls.items()}
    return gaps((served, served_post, [r["audio"].float() for r in reqs]))
