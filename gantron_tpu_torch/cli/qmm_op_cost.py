"""What binding qmm as a registered torch op costs the B = 1 decode.

    python -m gantron_tpu_torch.cli.qmm_op_cost [--pairs 12] [--steps 500]

The decoder step's four int8 products go through
``torch.ops.gantron_tpu_torch.qmm`` (``ops/quant.py``), whose CUDA
implementation, ``_qmm_cuda``, checks its inputs and launches
``csrc/qmm.cu``. Before the op existed, ``qmm`` called that implementation
directly. This times both bindings on one card, in alternating pairs (op
then direct, then direct then op), at HParams defaults plus ``use_noise``
and ``quantized_inference`` with random weights:

  * one eager call, (1, 1024) @ (1024, 4096), as ``profiling.benchmark``
    times it (the mean of 200 calls, the card's work finished);
  * the decoder alone at B = 1, 50 steps, seconds a step;
  * ``Synthesizer.infer_mel`` of one sentence at B = 1, ``--steps`` steps
    without early exit: text -> postnet mel.

The direct binding is put in place for its turns by patching the decoder
step's ``matmul_rhs`` (``models/tacotron2.py``) with one that calls
``_qmm_cuda``; both bindings must launch the kernel 4 times a step. Prints
one line per pair and, last, one JSON line with every sample, the medians,
the ranges and the paired differences (op minus direct), and ``gpu``
(``nvidia-smi``'s name and power limit).
"""

import argparse
import json
import statistics
from unittest import mock

TEXT = ("This voice was generated by a machine, measuring end to end "
        "synthesis speed.")


def summary(samples):
    return {"median": statistics.median(samples), "min": min(samples),
            "max": max(samples)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=12)
    parser.add_argument("--steps", type=int, default=500,
                        help="decoder steps of the infer_mel decode")
    args = parser.parse_args(argv)

    import torch

    from gantron_tpu_torch.cli.rtf import gpu_line
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.models import tacotron2
    from gantron_tpu_torch.ops import quant
    from gantron_tpu_torch.text import text_to_sequence
    from gantron_tpu_torch.tts import Synthesizer
    from gantron_tpu_torch.utils.profiling import StepTimer, benchmark

    if not torch.cuda.is_available():
        raise SystemExit("qmm_op_cost: no CUDA card")
    hp = HParams.create("use_noise=True,use_labels=False,"
                        f"quantized_inference=True,max_decoder_steps="
                        f"{args.steps}")
    synth = Synthesizer(hp, device="cuda", seed=0)
    decoder = synth.model.decoder
    W = decoder._scan_weights(quantize=True)
    x = torch.randn(1, W.wh1.q.shape[0], device="cuda")
    q, scale = W.wh1
    ids = torch.tensor([text_to_sequence(TEXT, hp.text_cleaners)],
                       device="cuda")
    memory = synth.model.encode_memory(
        ids, noise_generator=torch.Generator(device="cuda").manual_seed(1))
    card = torch.device("cuda")

    def direct_matmul_rhs(x, w):
        if isinstance(w, quant.QuantizedMatrix):
            return quant._qmm_cuda(x, w.q, w.scale)
        return x @ w

    def call(mode):
        if mode == "op":
            return torch.ops.gantron_tpu_torch.qmm.default(x, q, scale)
        return quant._qmm_cuda(x, q, scale)

    def decode():
        decoder.infer(memory, torch.Generator(device="cuda").manual_seed(0),
                      max_steps=50)

    def infer_mel():
        synth.infer_mel(TEXT, seed=0, early_exit=False)

    def measure(mode):
        """(µs a call, ms a decoder step, s an infer_mel) for ``mode``,
        and the kernel launches of one infer_mel."""
        timer = StepTimer(sync=True)
        per_call_us = benchmark(lambda: call(mode), warmup=20,
                                iters=200) * 1e6
        decode()  # warm-up of this binding
        timer.start(card)
        decode()
        step_ms = timer.stop(card) / 50 * 1e3
        quant.qmm.launches = 0
        timer.start(card)
        infer_mel()
        infer_s = timer.stop(card)
        return (per_call_us, step_ms, infer_s), quant.qmm.launches

    infer_mel()  # builds the kernel; cuDNN's warm-up
    names = ("call_us", "decode_step_ms", "infer_mel_s")
    samples = {mode: {n: [] for n in names} for mode in ("op", "direct")}
    for i in range(args.pairs):
        order = ("op", "direct") if i % 2 == 0 else ("direct", "op")
        line = []
        for mode in order:
            if mode == "op":
                values, launches = measure(mode)
            else:
                with mock.patch.object(tacotron2, "matmul_rhs",
                                       direct_matmul_rhs):
                    values, launches = measure(mode)
            if launches != 4 * args.steps:
                raise AssertionError(f"{mode}: {launches} qmm launches for "
                                     f"{args.steps} steps")
            for n, v in zip(names, values):
                samples[mode][n].append(v)
            line.append(f"{mode} {values[0]:.2f} us/call, {values[1]:.4f} "
                        f"ms/step, infer_mel {values[2]:.4f} s")
        print(f"pair {i}: " + "; ".join(line), flush=True)

    result = {"pairs": args.pairs, "steps": args.steps, "samples": samples,
              "gpu": gpu_line(), "device": torch.cuda.get_device_name(0)}
    for n in names:
        op, direct = samples["op"][n], samples["direct"][n]
        diff = [a - b for a, b in zip(op, direct)]
        result[n] = {"op": summary(op), "direct": summary(direct),
                     "op_minus_direct": summary(diff),
                     "pairs_op_slower": sum(d > 0 for d in diff)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
