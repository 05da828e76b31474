"""The adapter of ``gantron_tpu_torch`` (GANtron: Tacotron 2, WaveGlow and
the GAN training step), built from a configuration file and the
benchmark's weights. A configuration names it with ``"program":
"gantron"``; the adapters under ``perfbench/programs/`` are the only files
of the benchmark that import a program, and this one takes from it the
models, the training steps and the process group, nothing else.

What every adapter gives the harness: ``check(cfg)`` (raises where the
program is missing or refuses the configuration), ``defaults()`` (the
widths its model takes by default), ``TINY`` (the widths the CPU tests cut
its configurations to), ``join_group`` and ``leave_group`` (the program's
own process group, for cells on more than one card) and ``plant`` (the
faults the check is shown to catch). The traffic kinds call the rest."""

import torch

# The CPU tests' cut of each configuration: {section of the configuration
# file: the keys it overrides}, so that a whole run takes seconds.
TINY = {
    "model": dict(
        symbols_embedding_dim=16, encoder_embedding_dim=16,
        decoder_rnn_dim=24, prenet_dim=16, attention_rnn_dim=24,
        attention_dim=8, attention_location_n_filters=4,
        attention_location_kernel_size=5, postnet_embedding_dim=16,
        noise_size=8, speakers_embedding=4, discriminator_dim=16,
        discriminator_window=4, n_mel_channels=8, hop_length=4),
    "waveglow": dict(
        n_flows=4, n_group=4, n_early_every=2, n_early_size=1, n_layers=2,
        n_channels=8, kernel_size=3, upsample_kernel=8, upsample_stride=4),
}


def check(cfg):
    """The program's ``HParams`` of ``cfg``: fails where the program is
    missing or refuses the configuration."""
    return hparams(cfg)


def defaults():
    """Every field of the program's ``HParams`` at its default."""
    from gantron_tpu_torch.config import HParams

    return HParams().as_dict()


def join_group(address, world, rank, backend, timeout_s):
    """Joins this process to the program's process group, as a data
    parallel run of ``world`` processes does (rank 0 serves the rendezvous
    at ``address``, ``tcp://host:port``); the steps then reduce over it."""
    from gantron_tpu_torch.parallel.distributed import initialize_multihost

    return initialize_multihost(address, world, rank, backend=backend,
                                timeout_s=timeout_s)


def leave_group():
    from gantron_tpu_torch.parallel.distributed import shutdown

    shutdown()


def plant(fault, rank):
    """Breaks the program in this process, for the check's readings of a
    fault; returns what undoes it. ``"no_all_reduce"``: every rank but 0
    keeps its own values from the steps' all-reduces (the gradients, and
    the metrics' means), as if the reduced buffer were never copied back
    there; each still takes part in the exchange, so that no rank waits on
    another."""
    if fault != "no_all_reduce":
        raise ValueError(f"no fault named {fault!r}")
    from gantron_tpu_torch.train import step

    reduce = step.all_reduce_mean_

    def local(tensors):
        tensors = list(tensors)
        reduce([t.clone() for t in tensors])
        return tensors

    if rank != 0:
        step.all_reduce_mean_ = local

    def undo():
        step.all_reduce_mean_ = reduce

    return undo


def hparams(cfg):
    """The program's ``HParams``: its defaults, the configuration's
    ``hparams`` string, then every width of its ``model`` dict that the
    program has a field for."""
    from gantron_tpu_torch.config import HParams

    hp = HParams.create(cfg["hparams"])
    fields = set(hp.as_dict())
    for key, value in cfg["model"].items():
        if key in fields:
            hp.add_param(key, value)
    return hp


def synthesizer(cfg, W, P, device):
    """(Tacotron2 in eval mode, WaveGlow) with the benchmark's weights."""
    from gantron_tpu_torch.models.tacotron2 import Tacotron2
    from gantron_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig

    model = Tacotron2(hparams(cfg), device=device, seed=0).eval()
    model.load_state_dict(W, strict=True)
    dtype = getattr(torch, cfg["precision"]["waveglow"])
    vocoder = WaveGlow(WaveGlowConfig(
        n_mel_channels=cfg["model"]["n_mel_channels"], **cfg["waveglow"]), P,
        device, dtype=dtype)
    return model, vocoder


class Trainer:
    """The program's training state and its G and D steps."""

    def __init__(self, cfg, W, Wd, device, dropout_seed):
        from gantron_tpu_torch.models.discriminator import make_discriminator
        from gantron_tpu_torch.models.tacotron2 import Tacotron2
        from gantron_tpu_torch.train.state import wrap_models
        from gantron_tpu_torch.train.step import Batch, make_train_steps

        hp = self.hp = hparams(cfg)
        G = Tacotron2(hp, device=device, seed=0)
        G.load_state_dict(W, strict=True)
        D = make_discriminator(hp, device=device, seed=1)
        D.load_state_dict(Wd, strict=True)
        self.state, G, D, g_tx, d_tx = wrap_models(hp, G, D, 0)
        self.state.dropout_generator.manual_seed(dropout_seed)
        self._g, self._d, _ = make_train_steps(hp, G, D, g_tx, d_tx)
        self._batch = Batch

    def _as_batch(self, batch):
        text, tl, mels, gate, ol = batch
        B, dev = text.shape[0], text.device
        return self._batch(text, tl, mels, gate,
                           torch.zeros(B, dtype=torch.long, device=dev),
                           torch.zeros(B, 5, device=dev), ol)

    def g_step(self, batch, style, attn_weight):
        """One G step; (its generator loss, its postnet mel for D)."""
        self.state, metrics, (mel, _) = self._g(
            self.state, self._as_batch(batch), self.hp.g_learning_rate,
            attn_weight, style=style)
        return metrics["generator_loss"], mel

    def d_step(self, batch, fake, parts=False):
        """One D step on the batch's mels and ``fake``; its loss, or with
        ``parts`` its two terms (the real mels' and the generated ones')."""
        mels, ol = batch[2], batch[4]
        self.state, metrics = self._d(self.state, mels, ol, fake, ol,
                                      self.hp.d_learning_rate)
        if parts:
            return metrics["real_loss"], metrics["fake_loss"]
        return metrics["discriminator_loss"]

    def g_params(self):
        return list(self.state.g_model.named_parameters())

    def d_params(self):
        return list(self.state.d_model.named_parameters())

    def g_state(self):
        """Parameters and buffers (BatchNorm's running statistics)."""
        return list(self.state.g_model.state_dict().items())

    def d_state(self):
        return list(self.state.d_model.state_dict().items())

    def g_first_moments(self):
        return [(n, m) for (n, _), m in zip(self.g_params(),
                                           self.state.g_opt_state.mu)]

    def d_first_moments(self):
        return [(n, m) for (n, _), m in zip(self.d_params(),
                                           self.state.d_opt_state.mu)]

    def g_second_moments(self):
        return [(n, v) for (n, _), v in zip(self.g_params(),
                                           self.state.g_opt_state.nu)]

    def d_second_moments(self):
        return [(n, v) for (n, _), v in zip(self.d_params(),
                                           self.state.d_opt_state.nu)]

    def g_count(self):
        return self.state.g_opt_state.count

    def d_count(self):
        return self.state.d_opt_state.count

    def dropout_state(self):
        """The dropout generator's state (a host byte tensor)."""
        return self.state.dropout_generator.get_state()
