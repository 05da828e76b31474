"""One rank of the two-process gloo group that
tests/test_torch_parallel_steps.py spawns on the CPU.

    python tests/torch_parallel_worker.py PORT RANK ROOT REPO

``ROOT/inputs.pkl`` (written by the test) holds the JAX start state, the
global batch and style, the hparams of each scenario. Each scenario runs in
turn, in both ranks, and writes its result to ``ROOT/rank{RANK}.*``:

1. ``steps``: one G step and one D step of the port from the JAX state on
   this rank's rows of the global batch (dropout off, the style injected);
   the state and metrics after them.
2. ``guards``: the loop's guards that a group trips, each ValueError's
   message.
3. ``loop``: ``train.loop.train`` on ``"synthetic"`` for 3 iterations, each
   rank with its own output directory; then a rerun to 7 that resumes from
   the checkpoint that only the chief's directory holds; then 7 iterations
   uninterrupted in another directory. Every G and D step records the
   digests of the state's dropout and noise generators as it starts
   (``streams``).

With ``inputs["ident"]`` (tests/test_torch_parallel_identification.py) it
runs one scenario instead, ``ident``: one G step with the rollout and
identification terms from that JAX state on this rank's rows (dropout off,
the style and the rollout's draws injected for the global batch), writing
the state and metrics after it.
"""

import hashlib
import json
import os
import pickle
import sys


def main(port, rank, root):
    import torch

    torch.set_num_threads(1)
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.models.modules import disable_dropout
    from gantron_tpu_torch.parallel.distributed import (barrier,
                                                        initialize_multihost,
                                                        shutdown)
    from gantron_tpu_torch.parallel.mesh import shard_batch
    from gantron_tpu_torch.train import loop
    from gantron_tpu_torch.train.checkpoint import state_payload
    from gantron_tpu_torch.train.step import (Batch, make_train_steps,
                                              to_device)
    from gantron_tpu_torch.utils.jax_weights import train_state_from_jax
    from gantron_tpu_torch.utils.logging import MetricLogger

    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    assert initialize_multihost(f"localhost:{port}", 2, rank, backend="gloo",
                                timeout_s=120) == rank

    def hparams(over):
        hp = HParams()
        hp.add_params(over)
        return hp

    def out(name):
        return os.path.join(root, f"rank{rank}.{name}")

    def port_steps(over, state):
        hp = hparams(over)
        state, G, D, g_tx, d_tx = train_state_from_jax(state, hp,
                                                       device="cpu")
        disable_dropout(G)
        disable_dropout(D)
        return state, make_train_steps(hp, G, D, g_tx, d_tx)

    def local_batch(batch):
        return to_device(shard_batch(Batch(*batch), rank, 2), "cpu")

    def save(name, state, metrics):
        torch.save(state_payload(state), out(f"{name}.ckpt"))
        with open(out(f"{name}.json"), "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)

    lr = inputs["lr"]
    if "ident" in inputs:
        ident = inputs["ident"]
        state, (g_step, _, _) = port_steps(ident["hp"], ident["state"])
        state, metrics, _ = g_step(
            state, local_batch(ident["batch"]), lr["g"], lr["attn"], 1.0,
            style=ident["style"], draws=ident["draws"])
        barrier("ident")
        save("ident", state, metrics)
        shutdown()
        return

    # 1. One G and one D step from the JAX state.
    state, (g_step, d_step, _) = port_steps(inputs["hp"], inputs["state"])
    batch = local_batch(inputs["batch"])
    state, g_metrics, (mel, lengths) = g_step(
        state, batch, lr["g"], lr["attn"],
        style=torch.from_numpy(inputs["style"]))
    state, d_metrics = d_step(state, batch.mels, batch.output_lengths, mel,
                              lengths, lr["d"])
    barrier("steps")
    save("steps", state, {**g_metrics, **d_metrics})

    # 2. The guards that a group of two trips.
    messages = []
    for over in inputs["guards"]:
        try:
            loop.train(out("guard"), None, False, hparams(over),
                       "synthetic", logger=MetricLogger(None, quiet=True),
                       device="cpu")
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    with open(out("guards.json"), "w") as f:
        json.dump(messages, f)

    # 3. Three iterations, then a resume that only the chief can see; then
    # the same seven iterations uninterrupted.
    hp = hparams(inputs["loop_hp"])
    runs, streams = {}, {"resumed": {}, "uninterrupted": {}}
    make_steps = loop.make_train_steps

    def digest(g):
        return hashlib.sha256(g.get_state().numpy().tobytes()).hexdigest()

    def recording(record):
        """``make_train_steps`` whose G and D steps record the state's
        generators, by step, before they draw from them."""
        def recorded(step):
            def run(state, *args, **kw):
                record[state.step] = [digest(state.dropout_generator),
                                      digest(state.noise_generator)]
                return step(state, *args, **kw)
            return run

        def make(*args, **kw):
            g_step, d_step, eval_step = make_steps(*args, **kw)
            return recorded(g_step), recorded(d_step), eval_step
        return make

    loop.make_train_steps = recording(streams["resumed"])
    for iterations in (3, 7):
        hp.iterations = iterations
        state, it = loop.train(out("run"), None, False, hp, "synthetic",
                               device="cpu")
        runs[iterations] = {"iteration": it, "step": state.step}
        torch.save(state_payload(state), out(f"loop{iterations}.ckpt"))
    loop.make_train_steps = recording(streams["uninterrupted"])
    loop.train(out("whole"), None, False, hp, "synthetic", device="cpu")
    loop.make_train_steps = make_steps
    with open(out("loop.json"), "w") as f:
        json.dump(runs, f)
    with open(out("streams.json"), "w") as f:
        json.dump(streams, f)
    shutdown()


if __name__ == "__main__":
    port, rank, root, repo = sys.argv[1:5]
    sys.path.insert(0, repo)
    main(int(port), int(rank), root)
