"""The adapter of ``gantron_tpu_torch``'s Flowtron (``models/flowtron.py``,
its loss in ``losses.py`` and its training step in ``train/step.py``), built
from a configuration file and the benchmark's weights. A configuration
names it with ``"program": "flowtron"``; it takes from the program the
model, the training step, the process group and the spans, nothing else.

It gives the harness what every adapter gives (``programs/gantron.py``):
``check``, ``defaults``, ``TINY``, ``join_group``, ``leave_group`` and
``plant``; and to the traffic ``Trainer``, ``tracing()`` and ``summary()``
(the program's spans and counters, ``utils/profiling.py``)."""

# The CPU tests' cut of each configuration: {section: the keys it
# overrides}, so that a whole run takes seconds.
TINY = {
    "model": dict(
        n_text_dim=16, n_speaker_dim=8, n_attn_channels=12, n_hidden=20,
        n_mel_channels=6, encoder_embedding_dim=16),
}


def check(cfg):
    """The program's ``FlowtronConfig`` of ``cfg``: fails where the program
    is missing (a checkout without Flowtron) or refuses the
    configuration."""
    from gantron_tpu_torch.models.flowtron import Flowtron  # noqa: F401

    return config(cfg)


def defaults():
    """Every field of the program's ``FlowtronConfig`` at its default."""
    from gantron_tpu_torch.config import FlowtronConfig

    return FlowtronConfig().as_dict()


def config(cfg):
    """The program's ``FlowtronConfig``: its defaults, then every key of the
    configuration's ``model`` dict that it has a field for. Refuses the
    source's ``dummy_speaker_embedding`` set true, which the program does
    not implement."""
    from gantron_tpu_torch.config import FlowtronConfig

    if cfg["model"].get("dummy_speaker_embedding"):
        raise NotImplementedError("Flowtron here has no dummy speaker "
                                  "embedding")
    fields = set(FlowtronConfig().as_dict())
    return FlowtronConfig(**{k: v for k, v in cfg["model"].items()
                             if k in fields})


def join_group(address, world, rank, backend, timeout_s):
    from gantron_tpu_torch.parallel.distributed import initialize_multihost

    return initialize_multihost(address, world, rank, backend=backend,
                                timeout_s=timeout_s)


def leave_group():
    from gantron_tpu_torch.parallel.distributed import shutdown

    shutdown()


def plant(fault, rank):
    """Breaks the program in this process, for the check's readings of a
    fault; returns what undoes it. ``"no_reverse"``: every reversed flow
    runs over the frames in time order (its reversal by length left out,
    before the flow and after it)."""
    if fault != "no_reverse":
        raise ValueError(f"no fault named {fault!r}")
    from gantron_tpu_torch.models import flowtron

    reverse = flowtron.reverse_by_length
    flowtron.reverse_by_length = lambda x, lengths: x

    def undo():
        flowtron.reverse_by_length = reverse

    return undo


def tracing():
    """The program's ``tracing()`` session (a context manager)."""
    from gantron_tpu_torch.utils import profiling

    return profiling.tracing()


def summary():
    """The last ``tracing()`` session's spans and counters."""
    from gantron_tpu_torch.utils import profiling

    return profiling.summary()


class Trainer:
    """The program's Flowtron, its training state and its step, with the
    benchmark's weights ``W`` (every tensor of ``state_dict``)."""

    def __init__(self, cfg, W, device, dropout_seed):
        from gantron_tpu_torch.models.flowtron import Flowtron
        from gantron_tpu_torch.train.state import wrap_flowtron
        from gantron_tpu_torch.train.step import Batch, make_flowtron_step

        self.cfg = config(cfg)
        model = Flowtron(self.cfg, device=device, seed=0)
        model.load_state_dict(W, strict=True)
        self.state, tx = wrap_flowtron(self.cfg, model, dropout_seed)
        self._step = make_flowtron_step(self.cfg, model, tx)
        self._batch = Batch

    def step(self, batch):
        """One training step on (text, text_lengths, mels, gate,
        output_lengths, speaker_ids); its loss (a tensor on the card)."""
        text, tl, mels, gate, ol, spk = batch
        self.state, metrics = self._step(
            self.state, self._batch(text, tl, mels, gate, spk, None, ol),
            self.cfg.learning_rate)
        return metrics["loss"]

    def params(self):
        return list(self.state.model.named_parameters())

    def state_items(self):
        """Parameters and buffers (the encoder's running statistics)."""
        return list(self.state.model.state_dict().items())

    def first_moments(self):
        return [(n, m) for (n, _), m in zip(self.params(),
                                           self.state.opt_state.mu)]

    def second_moments(self):
        return [(n, v) for (n, _), v in zip(self.params(),
                                           self.state.opt_state.nu)]

    def count(self):
        return self.state.opt_state.count

    def dropout_state(self):
        """The dropout generator's state (a host byte tensor)."""
        return self.state.dropout_generator.get_state()
