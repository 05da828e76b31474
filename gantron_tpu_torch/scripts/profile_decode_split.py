"""Batch-1 text -> wav cost split: the Tacotron 2 decoder against the
WaveGlow flow (port of scripts/profile_decode_split.py).

    python -m gantron_tpu_torch.scripts.profile_decode_split [--device cpu]

Where batch-1 serving latency goes, to direct decode work. HParams
defaults with ``use_labels=False,use_noise=True`` (float weights: the
decode is not quantized, so the qmm kernel does not run) and random
weights from seed 0; WaveGlow at its published width with random weights
in bfloat16. One untimed decode of the sentence (all
``max_decoder_steps``, no early exit, as the JAX script's scan) and one
vocoding of its mel, then the median of 10 synchronized calls of each,
each with its own seed. Prints one JSON line: ``taco_ms``,
``waveglow_ms``, ``frames`` (the decoded length), ``wg_share`` and the
``device``.
"""

import argparse
import json
import statistics
import time

import numpy as np

from gantron_tpu_torch.scripts._study_common import (add_device_argument,
                                                     device_label,
                                                     print_launches)

TEXT = ("This voice was generated by a machine, measuring end to end "
        "synthesis speed.")


def profile(hp, wg_config, device="cuda", iters=10, text=TEXT):
    """The split for a model of ``hp`` and a WaveGlow of ``wg_config``:
    {"taco_ms", "waveglow_ms", "frames", "wg_share", "device"}."""
    import torch

    from gantron_tpu_torch.models.tacotron2 import Tacotron2
    from gantron_tpu_torch.models.waveglow import WaveGlow, random_params
    from gantron_tpu_torch.text import text_to_sequence
    from gantron_tpu_torch.utils.device import generator, resolve_device

    device = resolve_device(device)
    seq = torch.as_tensor(np.asarray(text_to_sequence(
        text, ["english_cleaners"]), np.int64)[None], device=device)
    model = Tacotron2(hp, device=device, seed=0)
    wg = WaveGlow(wg_config, random_params(torch.Generator().manual_seed(3),
                                           wg_config),
                  device=device, dtype=torch.bfloat16)

    def taco(i):
        gen = generator(device, i)
        out = model.infer(seq, generator=gen, noise_generator=gen)
        return out[1], out[4]

    def vocode(mel, i):
        return wg.infer(mel, 0.666, generator(device, i))

    def median_ms(fn):
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            fn(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    mel, lengths = taco(0)
    vocode(mel, 0)
    t_taco = median_ms(lambda i: taco(i)[0])
    t_wg = median_ms(lambda i: vocode(mel, i))
    return {"taco_ms": round(t_taco, 2), "waveglow_ms": round(t_wg, 2),
            "frames": int(lengths[0]),
            "wg_share": round(t_wg / (t_taco + t_wg), 3),
            "device": device_label(device)}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_argument(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.models.waveglow import WaveGlowConfig

    hp = HParams.create("use_labels=False,use_noise=True,scan_unroll=4")
    print(json.dumps(profile(hp, WaveGlowConfig(), args.device)), flush=True)
    print_launches()


if __name__ == "__main__":
    main()
