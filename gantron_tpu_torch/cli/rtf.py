"""Text -> wav real-time factor of the PyTorch port (counterpart of the root
``rtf.py``).

    python -m gantron_tpu_torch.cli.rtf                       # B = 1, card
    python -m gantron_tpu_torch.cli.rtf --batch 8             # audio s/s
    python -m gantron_tpu_torch.cli.rtf --streaming --chunk 40
    python -m gantron_tpu_torch.cli.rtf --taco_dtype bfloat16 \
        --hparams quantized_inference=True --result_dir out/
    python -m gantron_tpu_torch.cli.rtf --device cpu --hparams ...

Times the inference pipeline on one device: text -> Tacotron2 free-running
decode (``max_decoder_steps`` steps, no early exit) -> WaveGlow (bfloat16, as
``rtf.py`` runs it) -> waveform, after one untimed run. RTF = synthesis
seconds / audio seconds, the audio being the first sample's decoded frames;
``--batch B`` repeats the text B times and reports audio seconds per second
over every sample's frames. WaveGlow runs with ``--waveglow_path``'s weights
or random ones (the same compute and time), Tacotron2 with a port checkpoint
(``--checkpoint_path``) or random ones, whose gate is kept from firing
(``RANDOM_GATE_BIAS``) so that every sample decodes to the cap.

Prints one JSON line with ``rtf.py``'s fields, plus ``device`` (the CUDA
device's name, or ``cpu``), ``gpu`` (``nvidia-smi``'s name and power limit),
``decoder_steps`` and ``qmm_launches`` (the decoder steps and the int8
kernel's launches of the last timed synthesis: 4 a step with
``quantized_inference=True``, else 0). It writes a result file only with
``--result_dir``, and only there.
"""

import argparse
import json
import os
import subprocess

import numpy as np

DEFAULT_TEXT = ("This voice was generated by a machine, measuring end to end "
                "synthesis speed.")
# Random weights: the gate readout's bias, at which the gate never fires.
# The port's random gate fires at the first step for some styles, and RTF
# would then credit one frame of audio to a full decode; rtf.py's random
# model's gate rarely fires, so its samples run to the cap.
RANDOM_GATE_BIAS = -20.0


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="port checkpoint (random weights if absent)")
    parser.add_argument("--waveglow_path", type=str, default=None)
    parser.add_argument("--text", type=str, default=DEFAULT_TEXT)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--batch", type=int, default=1,
                        help="repeat the text B times: serving throughput "
                             "(aggregate audio seconds per second)")
    parser.add_argument("--taco_dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="Tacotron2 inference dtype (weights, BatchNorm "
                             "statistics and activations)")
    parser.add_argument("--hparams", type=str, default=None,
                        help="comma separated name=value overrides")
    parser.add_argument("--streaming", action="store_true",
                        help="chunked synthesis: reports the time to first "
                             "audio (TTFA) beside the RTF")
    parser.add_argument("--chunk", type=int, default=40,
                        help="streaming segment length in decoder steps")
    parser.add_argument("--lookback", type=int, default=16,
                        help="streaming vocoder context frames")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to synthesize on")
    parser.add_argument("--result_dir", type=str, default=None,
                        help="also write the JSON line to a file here")
    return parser.parse_args(argv)


def gpu_line():
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(argv=None, waveglow_config=None):
    """Runs the measurement and returns the result dict it printed.
    ``waveglow_config``: a ``WaveGlowConfig`` in place of the published
    width (tests use a narrow one)."""
    args = parse_args(argv)

    import torch

    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.models.tacotron2 import Tacotron2
    from gantron_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                                   load_waveglow,
                                                   random_params)
    from gantron_tpu_torch.ops.quant import qmm
    from gantron_tpu_torch.text import text_to_sequence
    from gantron_tpu_torch.tts import StreamingSynthesizer, Synthesizer
    from gantron_tpu_torch.utils.device import generator, resolve_device
    from gantron_tpu_torch.utils.profiling import StepTimer

    device = resolve_device(args.device)
    hp = HParams.create("use_labels=False,use_noise=True"
                        + ("," + args.hparams if args.hparams else ""))
    seq = np.asarray(text_to_sequence(args.text, ["english_cleaners"]),
                     np.int64)[None]
    text = np.repeat(seq, args.batch, axis=0)
    B = text.shape[0]

    if args.checkpoint_path:
        model = Synthesizer.from_checkpoint(args.checkpoint_path, hp,
                                            device).model
    else:
        model = Tacotron2(hp, device=device, seed=0).eval()
        model.decoder.gate_b.data.fill_(RANDOM_GATE_BIAS)
    if args.taco_dtype == "bfloat16":
        model = model.to(torch.bfloat16)
    cfg = waveglow_config or WaveGlowConfig()
    if args.waveglow_path:
        waveglow = load_waveglow(args.waveglow_path, cfg, device,
                                 dtype=torch.bfloat16)
    else:
        waveglow = WaveGlow(cfg, random_params(
            torch.Generator().manual_seed(3), cfg), device,
            dtype=torch.bfloat16)

    result = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "gpu": gpu_line() if device.type == "cuda" else None}
    if args.streaming:
        synth = StreamingSynthesizer(hp, model, waveglow, chunk=args.chunk,
                                     lookback=args.lookback, device=device)
        synth.synthesize(text, seed=0)  # warm-up (cuDNN's autotuning)
        ttfas, totals = [], []
        for i in range(args.iters):
            qmm.launches = 0
            wav, _, ttfa, total = synth.synthesize(text, seed=i + 1)
            ttfas.append(ttfa)
            totals.append(total)
        audio_seconds = wav.shape[1] / hp.sampling_rate
        synth_seconds = float(np.median(totals))
        result = {
            "metric": "streaming text->wav RTF + TTFA "
                      f"(chunk {args.chunk} steps, 1 device)",
            "value": synth_seconds / audio_seconds, "unit": "RTF",
            "ttfa_s": float(np.median(ttfas)), "synthesis_s": synth_seconds,
            "audio_s": audio_seconds, "chunk_steps": args.chunk,
            "taco_dtype": args.taco_dtype,
            "decoder_steps": synth.last_mel.shape[2] // hp.n_frames_per_step,
            **result}
    else:
        ids = torch.from_numpy(text).to(device)

        def synthesize(seed):
            out = model.infer(
                ids, early_exit=False,
                generator=generator(device, 3 * seed),
                noise_generator=generator(device, 3 * seed + 1))
            audio = waveglow.infer(out[1], 0.666,
                                   generator(device, 3 * seed + 2))
            return audio, out[4]

        synthesize(0)  # warm-up (cuDNN's autotuning)
        timer, times = StepTimer(sync=True), []
        for i in range(args.iters):
            qmm.launches = 0
            timer.start(device)
            audio, lengths = synthesize(i + 1)
            times.append(timer.stop(audio, lengths))
        lengths = lengths.cpu().numpy()
        frames = int(lengths[0])
        audio_seconds = frames * hp.hop_length / hp.sampling_rate
        total_audio_seconds = (float(lengths.sum()) * hp.hop_length
                               / hp.sampling_rate)
        synth_seconds = float(np.median(times))
        result = {
            "metric": "text->wav RTF (Tacotron2 decode + WaveGlow, 1 device)",
            "value": synth_seconds / audio_seconds, "unit": "RTF",
            "synthesis_s": synth_seconds, "audio_s": audio_seconds,
            "frames": frames, "taco_dtype": args.taco_dtype,
            "decoder_steps": hp.max_decoder_steps, **result}
        if B > 1:
            result.update(
                metric="text->wav serving throughput (batch "
                       f"{B}, Tacotron2 decode + WaveGlow, 1 device)",
                value=total_audio_seconds / synth_seconds,
                unit="audio_seconds/sec", batch=B)
    result["qmm_launches"] = qmm.launches
    print(json.dumps(result), flush=True)
    if args.result_dir:
        name = ("streaming_result.json" if args.streaming
                else "rtf_result.json" if B == 1
                else f"serving_b{B}_result.json")
        os.makedirs(args.result_dir, exist_ok=True)
        with open(os.path.join(args.result_dir, name), "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
