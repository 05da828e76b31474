"""GAN training loop (port of gantron_tpu/train/loop.py; reference:
train.py:211-466).

The G/D alternation schedule runs in host Python over the eager steps of
``train/step.py``. Schedule parity:

  * ``GEN_WARM`` = 5 generator-only warm-up steps;
  * discriminator-only phase until ``disc_warmp_up`` (sampling fakes from the
    ring buffer);
  * afterwards g_freq generator steps alternate with d_freq discriminator
    steps, plus ``DISC_BURST`` consecutive D steps every ``ITER_REP``
    iterations (reference train.py:297-299);
  * LR halving every ``reduce_lr_steps_every`` iterations;
  * validation + checkpoint every ``iters_per_checkpoint``.

Metrics are logged one step late, in one device-to-host copy a step, so the
host issues the next step before it waits for the last one's numbers.

Random streams: the JAX loop seeds validation with ``fold_in(PRNGKey(seed),
iteration + n)`` and the diversity probe with ``PRNGKey(seed + 17)``; the
port seeds ``torch.Generator``s from the same integers (``derive_seed``).
Threefry and Philox differ, so the draws differ and their distributions do
not. The training state's own generators are saved in its checkpoints.

Identification (adversarial rollouts, the InfoGAN terms and the code
terms; train/step.py): ``identification_warmup`` holds the terms at 0 for
its first iterations; after it their scale is the collapse-rescue
controller's (``update_rescue_scale``), whose sensor is the latent
separation ratio that the validation probe measures on one grid decode
(``eval.sampling.latent_separation``); the factor-aware rescue
(``factor_rescue_floor``) adds one grid decode a code dim and passes its
per-dim weights to the G step (``update_factor_scales``).

Data parallel (parallel/): with ``mesh_shape`` of N devices the loop runs
in each of N processes of one group, one card each. Every process builds
the same global batch and steps on its rows; the steps reduce over the
group. Only the chief logs, writes checkpoints, media and metrics, and
restores a checkpoint; the others get its state, iteration and learning
rates by broadcast. Each rank reseeds its dropout and noise generators
from (seed, iteration, rank) before every step, since a checkpoint holds
the chief's generators alone. Validation pads its last batch to the world size and
averages over the group. The diversity probe (and so the rescue
controllers) runs in a single process only, and ``max_seconds`` is ignored
with more than one (the processes' clocks would stop them at different
iterations), as in the JAX loop.
"""

import os
import random as pyrandom
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from gantron_tpu_torch.audio.mel import MelSpectrogram, mel_to_wav_griffin_lim
from gantron_tpu_torch.data.dataset import (DataLoader, PrefetchLoader,
                                            SyntheticDataset, TextMelDataset)
from gantron_tpu_torch.data.wav import write_wav
from gantron_tpu_torch.eval.sampling import (latent_separation,
                                             pairwise_sample_distance)
from gantron_tpu_torch.models.waveglow import load_waveglow
from gantron_tpu_torch.parallel import distributed
from gantron_tpu_torch.parallel.mesh import (make_mesh, pad_batch_rows,
                                             shard_batch, shard_state)
from gantron_tpu_torch.train.checkpoint import (CheckpointManager,
                                                warm_start_filter)
from gantron_tpu_torch.train.state import create_train_state
from gantron_tpu_torch.train.step import make_train_steps, to_device
from gantron_tpu_torch.utils.device import (derive_seed, generator,
                                           resolve_device)
from gantron_tpu_torch.utils import plotting
from gantron_tpu_torch.utils.loading import load_checkpoint_tree
from gantron_tpu_torch.utils.logging import MetricLogger

GEN_WARM = 5
ITER_REP = 10000
DISC_BURST = 100


def is_disc_turn(iteration, gen_times, disc_times, hp, buffer_len):
    """The G/D alternation decision (reference train.py:296-301):
    after 5 generator warm-up steps, the discriminator trains when its
    alternation counter is live, during its warm-up window, or during the
    100-step burst every 10k iterations — provided a generated mel exists."""
    do_disc = iteration >= ITER_REP and iteration % ITER_REP < DISC_BURST
    return (iteration > GEN_WARM
            and (disc_times > 0 or iteration < hp.disc_warmp_up or do_disc)
            and hp.d_freq > 0 and buffer_len > 0)


def advance_counters(d_turn, iteration, gen_times, disc_times, hp):
    """Post-step counter updates (reference train.py:357-359, 420-423)."""
    if d_turn:
        disc_times += 1
        if disc_times > hp.d_freq and iteration >= hp.disc_warmp_up:
            disc_times = 0
            gen_times = 1
    else:
        gen_times += 1
        if gen_times > hp.g_freq and hp.d_freq > 0:
            gen_times = 0
            disc_times = 1
    return gen_times, disc_times


def prepare_dataloaders(hp, wavs_path, device="cuda"):
    """(reference train.py:94-111). A corpus is featurized on ``device``."""
    if wavs_path == "synthetic":
        # Length ranges follow the configured buckets so every batch collates
        # to a bucket shape.
        t_in = (max(hp.text_buckets[-1] // 4, 4), hp.text_buckets[-1])
        t_out = (max(hp.mel_buckets[-1] // 3, 8), hp.mel_buckets[-1])
        trainset = SyntheticDataset(hp, size=max(hp.batch_size * 8, 64),
                                    t_in=t_in, t_out=t_out)
        valset = SyntheticDataset(hp, size=max(hp.batch_size * 2, 16),
                                  t_in=t_in, t_out=t_out, seed=1)
    else:
        trainset = TextMelDataset(hp.training_files, hp, wavs_path,
                                  device=device)
        valset = TextMelDataset(hp.validation_files, hp, wavs_path,
                                device=device)
    train_loader = DataLoader(trainset, hp, shuffle=True, drop_last=True)
    val_loader = DataLoader(valset, hp, shuffle=False, drop_last=False)
    return train_loader, val_loader


def validate(eval_step, state, val_loader, iteration, hp, logger,
             attn_steps, media_dir=None, vocoder=None):
    """Teacher-forced validation (reference train.py:169-208). When
    ``media_dir`` is set, renders alignment/mel/gate plots AND vocoded audio
    for 3 random samples of the last batch (reference logger.py:17-61;
    WaveGlow when provided, Griffin-Lim otherwise). Returns mel + gate
    loss, the mean over batches.

    In a process group each batch is repeat-padded to a multiple of the
    world size, each rank evaluates its rows, and the losses are averaged
    over the group (the padded batch's, as in the JAX loop); the media come
    from the chief's rows."""
    device = state.g_model.device
    rank, world = distributed.process_index(), distributed.process_count()
    losses, last = [], None
    for n, batch in enumerate(val_loader):
        batch = shard_batch(pad_batch_rows(batch, world), rank, world)
        metrics, out = eval_step(
            state, to_device(batch, device),
            generator(device, distributed.rank_seed(
                derive_seed(hp.seed, iteration + n))))
        losses.append(torch.stack([metrics["mel_loss"], metrics["gate_loss"],
                                   metrics["attention_loss"]]))
        last = (batch, out)
    if not losses:
        return float("inf")
    losses, = distributed.all_reduce_mean_([torch.stack(losses)])
    # One copy to the host for the whole pass.
    mel_l, gate_l, attn_l = losses.cpu().double().mean(0).tolist()
    if iteration > attn_steps:
        attn_l = 0.0

    if media_dir and last is not None:
        _save_validation_media(last, iteration, media_dir, hp, logger,
                               vocoder)
    logger.log_validation(mel_l, gate_l, attn_l, iteration)
    return mel_l + gate_l


def make_vocoder(hp, waveglow_path=None, device="cuda"):
    """Validation/inference vocoder on ``device``: WaveGlow (converted torch
    weights) when a checkpoint is given (reference logger.py:27-31),
    Griffin-Lim otherwise (reference audio_processing.py:59-75). Returns
    ``vocode(mel_bct numpy) -> (B, T_wav) float32 numpy``."""
    if waveglow_path:
        waveglow = load_waveglow(waveglow_path, device=device)

        def vocode(mel):
            return waveglow.infer(torch.from_numpy(mel), 0.666, generator(
                waveglow.device, 0)).cpu().numpy()
        return vocode

    mel_fn = MelSpectrogram(hp.filter_length, hp.hop_length, hp.win_length,
                            hp.n_mel_channels, hp.sampling_rate, hp.mel_fmin,
                            hp.mel_fmax, device=device)

    def vocode(mel):
        return mel_to_wav_griffin_lim(
            torch.from_numpy(mel), mel_fn, n_iters=30,
            generator=generator(mel_fn.device, 0)).cpu().numpy()
    return vocode


def _save_validation_media(last, iteration, media_dir, hp, logger=None,
                           vocoder=None):
    batch, out = last
    mel_post, gates, aligns = (x.float().cpu().numpy() for x in out[1:4])
    os.makedirs(media_dir, exist_ok=True)
    B = mel_post.shape[0]
    rnd = pyrandom.Random(iteration)
    idxs = rnd.sample(range(B), min(3, B))
    plots = plotting.available()
    if not plots and logger is not None:
        logger.info(f"{iteration} validation media: PNG plots skipped "
                    "(matplotlib is not installed); alignments saved as "
                    "_align.npy")
    images, audios = {}, {}
    for j, idx in enumerate(idxs):
        t_in = int(batch.text_lengths[idx])
        t_out = int(batch.output_lengths[idx])
        prefix = os.path.join(media_dir, f"iter{iteration}_s{j}")
        if plots:
            plotting.plot_alignment(aligns[idx, :t_out, :t_in].T,
                                    save_path=prefix + "_align.png")
            plotting.plot_spectrogram(mel_post[idx, :, :t_out],
                                      batch.mels[idx, :, :t_out],
                                      save_path=prefix + "_mel.png")
            sig = 1.0 / (1.0 + np.exp(-gates[idx, :t_out]))
            plotting.plot_gate_outputs(batch.gate[idx, :t_out], sig,
                                       save_path=prefix + "_gate.png")
            images[f"alignment_{j}"] = prefix + "_align.png"
            images[f"mel_{j}"] = prefix + "_mel.png"
            images[f"gate_{j}"] = prefix + "_gate.png"
        else:
            # The alignment's values where its plot would go: (T_in, T_out).
            np.save(prefix + "_align.npy", aligns[idx, :t_out, :t_in].T)
        if vocoder is not None:
            # Vocode at the batch's padded length, then cut to the true one.
            wav = vocoder(mel_post[idx: idx + 1])[0]
            wav = wav[: t_out * hp.hop_length]
            write_wav(prefix + ".wav", wav, hp.sampling_rate)
            audios[f"audio_{j}"] = wav
    if logger is not None:
        logger.log_media(iteration, images=images, audios=audios,
                         sample_rate=hp.sampling_rate)


def update_rescue_scale(scale: float, sensor: float, hp) -> float:
    """Collapse-rescue controller step (config.py diversity_rescue_*), a
    copy of the JAX package's pure host function.

    Two-sided feedback on the measured latent-separation ratio (between-code
    / within-code output distance on a decode grid):

    - sensor < ``diversity_rescue_floor``: the latent never took off —
      ESCALATE identification pressure by ``diversity_rescue_gain``,
      capped at ``diversity_rescue_max``.
    - sensor > ``diversity_rescue_ceiling``: the code's output effect has
      inflated past what on-manifold mode selection produces — ATTENUATE
      by the gain, floored at 1/``diversity_rescue_max``.
    - healthy band: decay back toward 1 from either side.

    Either bound may be 0 (= that side disabled); both 0 disables the
    controller (always 1.0). The loop's validation probe is its sensor and
    the G step's ``ident_scale`` its actuator."""
    floor = float(getattr(hp, "diversity_rescue_floor", 0.0) or 0.0)
    ceiling = float(getattr(hp, "diversity_rescue_ceiling", 0.0) or 0.0)
    if floor <= 0 and ceiling <= 0:
        return 1.0
    gain = max(float(getattr(hp, "diversity_rescue_gain", 2.0)), 1.0 + 1e-9)
    cap = max(float(getattr(hp, "diversity_rescue_max", 8.0)), 1.0)
    if floor > 0 and sensor < floor:
        return min(scale * gain, cap)
    if ceiling > 0 and sensor > ceiling:
        return max(scale / gain, 1.0 / cap)
    if scale > 1.0:
        return max(scale / gain, 1.0)
    return min(scale * gain, 1.0)


def update_factor_scales(scales, per_dim, hp, iteration=None):
    """Factor-aware rescue controller step (config.py factor_rescue_floor),
    a copy of the JAX package's pure host function.

    ``scales``: per-code-dim redraw weights (host floats, start at 1.0).
    ``per_dim``: the measured per-dim separation ratios. A dim below the
    floor gets its weight multiplied by ``diversity_rescue_gain`` (capped at
    ``diversity_rescue_max``); healthy dims decay back toward 1. Before
    ``factor_rescue_warmup`` iterations the controller is unarmed (weights
    held at 1.0)."""
    floor = float(getattr(hp, "factor_rescue_floor", 0.0) or 0.0)
    if floor <= 0:
        return [1.0] * len(scales)
    warmup = int(getattr(hp, "factor_rescue_warmup", 0) or 0)
    if iteration is not None and iteration < warmup:
        return [1.0] * len(scales)
    gain = max(float(getattr(hp, "diversity_rescue_gain", 2.0)), 1.0 + 1e-9)
    cap = max(float(getattr(hp, "diversity_rescue_max", 8.0)), 1.0)
    out = []
    for s, r in zip(scales, per_dim):
        if r < floor:
            out.append(min(s * gain, cap))
        else:
            out.append(max(s / gain, 1.0))
    return out


def _check_loop_config(hp, world):
    """The JAX loop's fail-fast guards (loop.py:317-365) for ``world``
    processes, the mesh's among them (parallel/mesh.py::make_mesh)."""
    if (float(getattr(hp, "diversity_rescue_floor", 0.0) or 0.0) > 0
            or float(getattr(hp, "diversity_rescue_ceiling", 0.0) or 0.0)
            > 0):
        if (getattr(hp, "validation_sample_diversity", 0) or 0) < 2 \
                or world > 1:
            raise ValueError(
                "diversity_rescue_floor/ceiling > 0 requires the collapse "
                "detector: set validation_sample_diversity >= 2 (the probe "
                "is single-process only)")
        if not (float(getattr(hp, "diversity_weight", 0.0)) > 0
                or float(getattr(hp, "style_reconstruction_weight",
                                 0.0)) > 0):
            raise ValueError(
                "diversity_rescue_floor/ceiling > 0 requires "
                "diversity_weight > 0 or style_reconstruction_weight > 0: "
                "the rescue scale multiplies exactly those loss terms")
    if float(getattr(hp, "factor_rescue_floor", 0.0) or 0.0) > 0:
        if int(getattr(hp, "style_code_dims", 0) or 0) < 2:
            raise ValueError(
                "factor_rescue_floor > 0 requires style_code_dims >= 2: "
                "the per-dim sensor is only distinct from the diagonal "
                "one for multi-dim codes (config.py factor_rescue_floor)")
        if (getattr(hp, "validation_sample_diversity", 0) or 0) < 2 \
                or world > 1:
            raise ValueError(
                "factor_rescue_floor > 0 requires the collapse detector: "
                "set validation_sample_diversity >= 2 (the probe is "
                "single-process only)")
        if not float(getattr(hp, "diversity_weight", 0.0)) > 0:
            raise ValueError(
                "factor_rescue_floor > 0 requires diversity_weight > 0: "
                "the per-dim redraw weights bias the diversity pair's "
                "subset redraw")
    mesh = make_mesh(hp.mesh_shape)
    if world > 1 and hp.batch_size % mesh.size != 0:
        raise ValueError(
            f"batch_size={hp.batch_size} is not divisible by the "
            f"{mesh.size}-device data mesh; adjust batch_size or mesh_shape")


def _make_diversity_probe(hp, val_loader):
    """The free-running mode-collapse detector (config.py
    validation_sample_diversity), or None when it is off or more than one
    process trains (its decode runs outside the collective steps): at each
    validation it decodes one fixed validation text and returns (spread,
    separation ratio or None, per-dim ratios or None). Teacher-forced val
    mel is structurally blind to mode collapse.

    With a rescue controller on (``diversity_rescue_floor``/``ceiling`` or
    ``factor_rescue_floor``) one latent-separation grid decode feeds both
    the controller's sensor (the scale-free between/within-code ratio) and
    the logged spread, and the factor-aware rescue adds one grid decode a
    code dim (``eval.sampling.latent_separation``); else M samples of the
    text give the spread alone."""
    if ((getattr(hp, "validation_sample_diversity", 0) or 0) <= 1
            or distributed.process_count() > 1):
        return None
    probe_batch = next(iter(val_loader), None)
    if probe_batch is None:
        return None
    M = int(hp.validation_sample_diversity)
    t_len = max(int(probe_batch.text_lengths[0]), 1)
    probe_text = np.asarray(probe_batch.text)[:1, :t_len]
    use_separation = (float(hp.diversity_rescue_floor or 0.0) > 0
                      or float(hp.diversity_rescue_ceiling or 0.0) > 0)
    code_dims = int(hp.style_code_dims or 0)
    factor_dims = (code_dims if float(hp.factor_rescue_floor or 0.0) > 0
                   and code_dims >= 2 else 0)

    def probe(state, it):
        G = state.g_model
        seed = derive_seed(hp.seed + 17, it)
        if use_separation or factor_dims:
            # Each grid decode starts its generator at the same seed: the
            # per-dim grids share the diagonal grid's nuisance draws.
            ratio, spread = latent_separation(
                G, hp, probe_text, generator(G.device, seed))
            per_dim = None
            if factor_dims:
                per_dim = [latent_separation(
                    G, hp, probe_text, generator(G.device, seed), dim=d)[0]
                    for d in range(factor_dims)]
            return spread, ratio, per_dim
        text = torch.as_tensor(probe_text, dtype=torch.long,
                               device=G.device).expand(M, t_len)
        out = G.infer(text, None, None, None, hp.max_decoder_steps,
                      generator=generator(G.device, derive_seed(seed, 0)),
                      noise_generator=generator(G.device,
                                                derive_seed(seed, 1)))
        return pairwise_sample_distance(out[1].cpu().numpy(),
                                        out[4].cpu().numpy()), None, None
    return probe


def train(output_directory: str, checkpoint_path: Optional[str],
          warm_start: bool, hp, wavs_path: str,
          logger: Optional[MetricLogger] = None, real: float = 1.0,
          max_seconds: Optional[float] = None,
          waveglow_path: Optional[str] = None, device="cuda"):
    """Main entry (reference train.py:211-440), on ``device`` (the card
    unless ``device="cpu"`` is passed; in a process group ``"cuda"`` is the
    rank's card). Returns (state, iteration)."""
    device = resolve_device(device)
    rank, world = distributed.process_index(), distributed.process_count()
    # Rank-0 gating (reference train.py:426-431): the other processes run
    # every collective step and validation but write nothing.
    chief = distributed.is_chief()
    if chief:
        os.makedirs(output_directory, exist_ok=True)
    else:
        logger = MetricLogger(None, quiet=True)
    logger = logger or MetricLogger(output_directory)
    _check_loop_config(hp, world)
    vocoder = None
    if chief and getattr(hp, "validation_audio", True):
        vocoder = make_vocoder(hp, waveglow_path, device)

    train_loader, val_loader = prepare_dataloaders(hp, wavs_path, device)

    sample = next(iter(train_loader))
    state, g_model, d_model, g_tx, d_tx = create_train_state(
        hp, hp.seed, sample, device)
    g_step, d_step, eval_step = make_train_steps(
        hp, g_model, d_model, g_tx, d_tx, real=real)
    diversity_probe = _make_diversity_probe(hp, val_loader)
    rescue_scale = 1.0
    # The factor-aware rescue's per-dim weights (all 1.0: the unweighted
    # draws), updated at each validation from the per-dim probe.
    factor_scales = ([1.0] * int(hp.style_code_dims or 0)
                     if float(hp.factor_rescue_floor or 0.0) > 0 else [])

    ckpt = CheckpointManager(output_directory)
    iteration = 0
    g_lr, d_lr = hp.g_learning_rate, hp.d_learning_rate
    if checkpoint_path is None and not warm_start:
        # Auto-resume: a preempted run restarted with the same command picks
        # up from the newest checkpoint in its output directory.
        latest = ckpt.latest()
        if latest is not None:
            logger.info(f"Auto-resuming from {latest}")
            checkpoint_path = latest
    if checkpoint_path is not None and chief:
        if warm_start:
            restored = load_checkpoint_tree(checkpoint_path)["g_state"]
            # BatchNorm running statistics are state_dict entries, so they
            # carry over with the weights, as the reference's
            # load_state_dict carries them (train.py:128-140).
            g_model.load_state_dict(warm_start_filter(
                g_model.state_dict(), restored, hp.ignore_layers))
        else:
            state = ckpt.restore(checkpoint_path, state)
            # state.step == completed steps == the iteration counter at save
            # time (both increment once per batch); the next batch's index
            # IS state.step — a +1 here would skip one schedule index per
            # resume.
            iteration = state.step
            if hp.use_saved_learning_rate:
                # Restore the LRs stored with the checkpoint (reference
                # train.py:266-269), so off-schedule adjustments survive a
                # resume.
                meta = CheckpointManager.load_meta(checkpoint_path)
                if meta is not None:
                    g_lr = float(meta.get("g_lr", g_lr))
                    d_lr = float(meta.get("d_lr", d_lr))
    if world > 1:
        # Only the chief may have found a checkpoint (no shared file system
        # needed): every process resumes from its state, iteration and
        # learning rates, or the G/D schedules would part and the
        # collectives hang.
        iteration, g_lr, d_lr = shard_state(state, iteration, g_lr, d_lr)
        iteration = int(iteration)
        if max_seconds is not None:
            logger.info("max_seconds ignored in multi-process runs "
                        "(iteration-based stopping only)")
            max_seconds = None

    n_epochs = hp.epochs
    if hp.iterations is not None and hp.iterations > 0:
        n_epochs = int(hp.iterations / max(len(train_loader), 1)) + 1

    gen_times, disc_times = 1, 0
    generated_mel_list = []  # ring buffer of (mel, lengths), ≤ d_freq
    pending_log = None  # (step, dict) logged one step late
    t_start = time.time()
    rnd = pyrandom.Random(hp.seed)
    media_dir = os.path.join(output_directory, "media") if chief else None

    def validate_and_save():
        nonlocal rescue_scale, factor_scales
        t0 = time.perf_counter()
        val_loss = validate(eval_step, state, val_loader, iteration, hp,
                            logger, hp.attn_steps, media_dir=media_dir,
                            vocoder=vocoder)
        if diversity_probe is not None:
            diversity, separation, per_dim = diversity_probe(state,
                                                             iteration)
            extra = {}
            if separation is not None:
                # The controller's sensor is the separation ratio, never
                # the raw spread.
                rescue_scale = update_rescue_scale(rescue_scale, separation,
                                                   hp)
                extra["identification_separation"] = separation
                extra["identification_rescue_scale"] = rescue_scale
            if per_dim is not None:
                factor_scales = update_factor_scales(factor_scales, per_dim,
                                                     hp, iteration)
                for d, (r, sc) in enumerate(zip(per_dim, factor_scales)):
                    extra[f"identification_separation_dim{d}"] = r
                    extra[f"factor_rescue_scale_dim{d}"] = sc
            logger.log_values(iteration, sample_diversity=diversity, **extra)
        t1 = time.perf_counter()
        path = ckpt.save(state, iteration, val_loss,
                         extra={"g_lr": g_lr, "d_lr": d_lr})
        if path is not None:
            logger.save_file(path)
        logger.log_values(iteration, validation_duration=t1 - t0,
                          checkpoint_duration=time.perf_counter() - t1)
        return val_loss

    def flush_log():
        nonlocal pending_log
        if pending_log is not None:
            step_i, metrics = pending_log
            # One device-to-host copy for the step's tensors.
            keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
            if keys:
                values = torch.stack([metrics[k].float() for k in keys]) \
                    .cpu().tolist()
                metrics.update(zip(keys, values))
            host = {k: float(v) for k, v in metrics.items()}
            logger.log_values(step_i, **host)
            key = ("generator_loss" if "generator_loss" in host
                   else "discriminator_loss")
            logger.progress(step_i, hp.iterations, **{key: host[key]})
            pending_log = None

    for epoch in range(n_epochs):
        batches = iter(PrefetchLoader(train_loader))
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            start = time.perf_counter()
            batch = to_device(shard_batch(batch, rank, world), device)
            if world > 1:
                # A checkpoint holds the chief's generators alone, so each
                # rank draws from (seed, iteration, rank): a resume then
                # continues every rank's dropout and noise streams.
                state.seed_generators(derive_seed(hp.seed, iteration))
            d_turn = is_disc_turn(iteration, gen_times, disc_times, hp,
                                  len(generated_mel_list))

            if d_turn:
                idx = min(disc_times - 1, len(generated_mel_list) - 1)
                gen_mel, gen_lengths = generated_mel_list[idx]
                if iteration < hp.disc_warmp_up:
                    gen_mel, gen_lengths = rnd.choice(generated_mel_list)
                # Pad both mels to the largest bucket (as the JAX loop does
                # for one compiled shape); the padding is masked out by the
                # per-sample valid-window counts.
                T_max = max(hp.mel_buckets[-1], batch.mels.shape[2],
                            gen_mel.shape[2])
                T_max = -(-T_max // hp.discriminator_window) * \
                    hp.discriminator_window
                state, metrics = d_step(
                    state, F.pad(batch.mels, (0, T_max - batch.mels.shape[2])),
                    batch.output_lengths,
                    F.pad(gen_mel, (0, T_max - gen_mel.shape[2])),
                    gen_lengths, d_lr)
                flush_log()
                metrics["discriminator_learning_rate"] = d_lr
                metrics["discriminator_duration"] = (
                    time.perf_counter() - start)
            else:
                attn_w = 10.0 if iteration < hp.attn_steps else 0.0
                # Identification warm-up: the InfoGAN terms stay at 0 until
                # D has anchored the manifold; then the rescue controller's
                # scale (1.0 unless it has tripped).
                ident_w = (0.0 if iteration < int(hp.identification_warmup)
                           else rescue_scale)
                state, metrics, fake_pair = g_step(
                    state, batch, g_lr, attn_w, ident_w,
                    factor_scales or None)
                generated_mel_list.append(fake_pair)
                if len(generated_mel_list) > max(hp.d_freq, 1):
                    generated_mel_list.pop(0)
                flush_log()
                if iteration >= hp.attn_steps:
                    metrics.pop("attention_loss", None)
                metrics["generator_learning_rate"] = g_lr
                metrics["generation_duration"] = time.perf_counter() - start
            metrics["data_duration"] = start - t_wait
            pending_log = (iteration, metrics)

            gen_times, disc_times = advance_counters(
                d_turn, iteration, gen_times, disc_times, hp)
            iteration += 1

            validated_at = -1
            if iteration % hp.iters_per_checkpoint == 0:
                flush_log()
                validate_and_save()
                validated_at = iteration

            if (hp.reduce_lr_steps_every > 0
                    and iteration % int(hp.reduce_lr_steps_every) == 0):
                g_lr /= 2
                d_lr /= 2

            stop = ((hp.iterations is not None and hp.iterations > 0
                     and iteration >= hp.iterations)
                    or (max_seconds and time.time() - t_start > max_seconds))
            if stop:
                flush_log()
                if validated_at != iteration:  # avoid double validate+save
                    validate_and_save()
                return state, iteration
    flush_log()
    return state, iteration
