"""What the product route of the BatchNorm-fed convolutions costs the G step.

    python -m gantron_tpu_torch.cli.conv_route_cost [--pairs 5]

The encoder's and postnet's convolutions feed training BatchNorms and go
through ``ops/conv.py``: a float32 step under autograd takes the explicit
product (``ProductConv``), a bfloat16 one (``fp16_run``) cuDNN. This times
one G step at bench.py's shape (``cli/bench.py``'s batch: B 32, T_in 128,
T_out 640; ``use_labels=False,use_noise=True``, learning rate 1e-3,
attention weight 10) on one card with those convs on the shipped route and
on cuDNN's (``utils/precision.audit_setting(..., "cudnn")``), in
alternating pairs after one warm-up step each, in float32 and with
``fp16_run``. Each step is timed on the host clock up to a synchronize,
with the card's peak memory. Prints one line per pair and, last, one JSON
line with every sample, the medians and ranges, the ratios of the medians
(cuDNN over shipped) and ``gpu`` (``nvidia-smi``'s name and power limit).
"""

import argparse
import json
import statistics
import time

LR, ATTN_WEIGHT = 1e-3, 10.0
ROUTES = ("shipped", "cudnn")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=5)
    args = parser.parse_args(argv)

    import torch

    from gantron_tpu_torch.cli.bench import make_batch
    from gantron_tpu_torch.cli.rtf import gpu_line
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.train.state import create_train_state
    from gantron_tpu_torch.train.step import (Batch, make_train_steps,
                                              to_device)
    from gantron_tpu_torch.utils.precision import audit_setting

    if not torch.cuda.is_available():
        raise SystemExit("conv_route_cost: no CUDA card")
    result = {"gpu": gpu_line(), "pairs": args.pairs}
    for mode in ("float32", "fp16_run"):
        hp = HParams.create("use_labels=False,use_noise=True"
                            + (",fp16_run=True" if mode == "fp16_run"
                               else ""))
        batch = to_device(Batch(*make_batch(hp)), "cuda")
        setups = {}
        for route in ROUTES:
            state, G, D, g_tx, d_tx = create_train_state(hp, 0, batch,
                                                         "cuda")
            setups[route] = [state, make_train_steps(hp, G, D, g_tx,
                                                     d_tx)[0]]
        seconds = {r: [] for r in ROUTES}
        peak = {r: 0 for r in ROUTES}

        def step(route, record=True):
            state, g_step = setups[route]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with audit_setting(state.g_model, route):
                state, metrics, _ = g_step(state, batch, LR, ATTN_WEIGHT)
            torch.cuda.synchronize()
            if record:
                seconds[route].append(time.perf_counter() - t0)
                peak[route] = max(peak[route],
                                  torch.cuda.max_memory_allocated())
            return float(metrics["generator_loss"])

        for route in ROUTES:
            step(route, record=False)
        for i in range(args.pairs):
            order = ROUTES if i % 2 == 0 else ROUTES[::-1]
            for route in order:
                step(route)
            print(f"{mode} pair {i}: " + ", ".join(
                f"{r} {seconds[r][-1]:.3f} s" for r in order), flush=True)
        med = {r: statistics.median(s) for r, s in seconds.items()}
        result[mode] = {
            "g_step_s": seconds, "median_s": med,
            "range_s": {r: [min(s), max(s)] for r, s in seconds.items()},
            "cudnn_over_shipped": med["cudnn"] / med["shipped"],
            "peak_memory_bytes": peak}
        del setups
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
