"""How much of the G step's backward is the in-loop weights' gradient
accumulation? (port of scripts/ablate_dw.py)

    python -m gantron_tpu_torch.scripts.ablate_dw [--device cpu]

The decoder loop's backward accumulates the gradient of every weight read
inside the loop (the two LSTMs' matrices, the attention's query, energy
and location weights) over all T_out steps. At bench.py's shape (B 32,
T_out 640, bfloat16 forward copies of float32 masters), with the plain
backward (no deferred-dW offsets), on the teacher-forced Tacotron 2 loss
with attention weight 10:

  fwd            the forward pass alone (no autograd history)
  grad_full      the loss and its gradient with respect to every
                 generator parameter
  grad_no_scanW  the same with the in-loop decoder weights as constants
                 (their gradients not asked for; the data gradients still
                 flow through the loop to the encoder and the embedding)

grad_full - grad_no_scanW is about the cost of the in-loop dW
accumulation. Each is the median of synchronized calls after a warm-up.
"""

import statistics
import time

from gantron_tpu_torch.cli.bench import BATCH, T_IN, T_OUT, make_batch
from gantron_tpu_torch.scripts._study_common import device_label
from gantron_tpu_torch.scripts.ablate_deferred import ATTN_WEIGHT, parse_args

# Weights read inside the decoder loop (the prenet, the attention LSTM's
# input projection, the memory projection and the output and gate
# projections run outside it).
IN_SCAN = ("attention_rnn", "decoder_rnn", "query_w", "v_w", "loc_conv_w",
           "loc_dense_w")


def in_scan(name):
    parts = name.split(".")
    return parts[0] == "decoder" and parts[1] in IN_SCAN


def time_it(fn, device, warmup=2, iters=6):
    """Median seconds of ``iters`` synchronized calls after ``warmup``."""
    import torch

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def measure(device="cuda", B=BATCH, T_in=T_IN, T_out=T_OUT, warmup=2,
            iters=6, hp_over=None):
    """{"fwd", "grad_full", "grad_no_scanW"}: median seconds of each;
    ``hp_over`` (a dict) narrows the model for a short run."""
    import torch

    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.losses import tacotron2_loss
    from gantron_tpu_torch.train.state import create_train_state
    from gantron_tpu_torch.train.step import Batch, _forward, to_device
    from gantron_tpu_torch.utils.device import generator

    hp = HParams.create("use_labels=False,use_noise=True,fp16_run=True")
    if hp_over:
        hp.add_params(hp_over)
    batch = to_device(Batch(*make_batch(hp, B=B, T_in=T_in, T_out=T_out)),
                      device)
    G = create_train_state(hp, 0, batch, device=device)[1]
    named = list(G.named_parameters())

    def loss_fn():
        gen = generator(batch.mels.device, 1)
        out = _forward(G, torch.bfloat16, batch.text, batch.text_lengths,
                       batch.mels.to(torch.bfloat16), batch.speaker,
                       batch.emotions, batch.output_lengths, train=True,
                       generator=gen, noise_generator=gen)
        mel_l, gate_l, attn_l = tacotron2_loss(
            [o.float() for o in out], (batch.mels, batch.gate),
            batch.text_lengths, batch.output_lengths)
        return mel_l + gate_l + ATTN_WEIGHT * attn_l

    def fwd():
        with torch.no_grad():
            return loss_fn()

    def grad_full():
        return torch.autograd.grad(loss_fn(), [p for _, p in named])

    def grad_no_scanw():
        frozen = [p for n, p in named if in_scan(n)]
        for p in frozen:
            p.requires_grad_(False)
        try:
            return torch.autograd.grad(
                loss_fn(), [p for n, p in named if not in_scan(n)])
        finally:
            for p in frozen:
                p.requires_grad_(True)

    return {name: time_it(fn, device, warmup, iters)
            for name, fn in (("fwd", fwd), ("grad_full", grad_full),
                             ("grad_no_scanW", grad_no_scanw))}


def run(device="cuda", **shape):
    """The script's measurement and lines; ``shape`` goes to ``measure``."""
    print(f"device {device_label(device)}", flush=True)
    t = measure(device, **shape)
    full, now = t["grad_full"], t["grad_no_scanW"]
    print(f"fwd            {t['fwd']*1e3:8.1f} ms")
    print(f"grad_full      {full*1e3:8.1f} ms")
    print(f"grad_no_scanW  {now*1e3:8.1f} ms")
    print(f"in-scan dW accumulation cost ~= {(full-now)*1e3:8.1f} ms "
          f"({100*(full-now)/full:.0f}% of full grad)", flush=True)
    return t


def main(argv=None):
    run(parse_args(argv).device)


if __name__ == "__main__":
    main()
