"""Data parallel over two processes: the port's G and D steps and training
loop in a two-rank gloo group on the CPU (tests/torch_parallel_worker.py,
spawned once for the module with a free port), against the JAX package's
step on a 2-device mesh (conftest's virtual devices) and the port's
one-process step.

From one JAX state, dropout off and the style injected, global batch 4 (2
rows a rank): the states after one G and one D step at
``assert_states_match``'s tolerances (``STATE_TOL``) against the port's
one-process step, BatchNorm running statistics and metrics equal on both
ranks. Against JAX's mesh step the moments are held at ``MESH_TOL``, three
times ``STATE_TOL``'s, except for the seven tensors of ``MESH_NOISY``, held
at pinned bounds; the test holds JAX's own mesh step against its
single-device step at ``MESH_TOL`` too. Those bounds are float32 noise
that depends on the host: the embedding's gradient is a scatter-add over
token ids and the convolutions' and the encoder LSTM's are sums over every
(B, T) position, which the 2-device program and the single-device one add
in different orders, and a conv bias before a training-mode BatchNorm has
an exact gradient of 0 and holds rounding noise alone. Readings, in
shares of ``STATE_TOL``'s tolerance of each kind:

* JAX's mesh step against its single-device step: 2.6 at most on an AMD
  EPYC host (the embedding's first moment); every other check within
  ``MESH_TOL``. On an Intel Xeon host the first moments of the embedding
  3.80, ``encoder.convs.1.conv.weight`` 3.71,
  ``postnet.convs.0.conv.weight`` 3.67, ``encoder.lstm_fw.w_hh`` 3.11 and
  ``encoder.convs.0.conv.weight`` 3.08, every other tensor's 2.83 at most
  (``decoder.proj_w``), the second moments 2.35 at most; D's
  ``convs.0.conv.weight`` values 1.39 of ``STATE_TOL``'s parameter
  tolerance after the D step (every other tensor's 0.86 at most); and the
  single-device step's ``postnet.convs.0.conv.bias`` holds noise of
  1.40e-6 of the largest first moment (the mesh step's 5.7e-7, the port's
  steps 7.4e-8 at most), over ``STATE_TOL``'s 1e-6. The pinned bounds are
  those readings with about a third to spare: ``MESH_MOMENT_TOL`` 5 (3.80
  x 1.32), ``MESH_PARAM_TOL`` 2 (1.39 x 1.44), ``MESH_BIAS_NOISE_TOL``
  2e-6 (1.40e-6 x 1.43).
* Each rank against JAX's mesh step: 1.1 (AMD EPYC); 1.59 (Intel Xeon, the
  embedding), 1.23 once the training BatchNorm took its statistics from
  float64 sums.
* Each rank against the port's one process: 1.00 on the Intel Xeon host
  (``postnet.convs.0.conv.weight``; the port's one-process step against
  itself with the batch's rows reversed: 1.23), over ``STATE_TOL``; 0.15
  with the float64 sums (the rows reversed: 0.17).

Then the loop's guards that a group trips, with JAX's messages, and the
loop: the chief writes, rank 1 writes nothing, a resume whose checkpoint
only the chief can see leaves both ranks at the same iteration with the
same state, and every rank's random streams continue across it.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import types

import pytest

import jax
import jax.numpy as jnp
import torch

import gantron_tpu.train.loop as jax_loop
from gantron_tpu.parallel import make_mesh as jax_make_mesh
from gantron_tpu.parallel import shard_batch as jax_shard_batch
from gantron_tpu.parallel import shard_state as jax_shard_state
from gantron_tpu.train.state import create_train_state as jax_create_state
from gantron_tpu.train.step import make_train_steps as jax_make_steps
from gantron_tpu.utils.logging import MetricLogger as JaxLogger
from gantron_tpu_torch.models.modules import disable_dropout
from gantron_tpu_torch.train.checkpoint import CheckpointManager
from gantron_tpu_torch.train.state import compare_states
from gantron_tpu_torch.train.step import Batch, make_train_steps, to_device
from gantron_tpu_torch.utils.jax_weights import train_state_from_jax
from test_loop import tiny_hp as loop_tiny_hp
from test_torch_train import (ATTN_W, D_LR, D_METRICS, G_LR, G_METRICS,
                              STEP_TOL, JaxRun, d_loss_close, jax_dropout_off,  # noqa: F401
                              np_tree, port_hp, rel_close)
from test_train_step import synth_batch, tiny_hp
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
B = 4
# The loop's guards that a group of two trips (over tests/test_loop.py's
# tiny hparams with mesh_shape=[2]); the last has no JAX counterpart.
GUARDS = [dict(batch_size=3),
          dict(diversity_rescue_floor=0.5, validation_sample_diversity=3,
               diversity_weight=1.0),
          dict(factor_rescue_floor=2.0, style_code_dims=2,
               validation_sample_diversity=3),
          dict(mesh_shape=[4])]
LOOP_OVER = dict(mesh_shape=[2], iterations=3, iters_per_checkpoint=3)


def guard_hp(case):
    return loop_tiny_hp(**{"mesh_shape": [2], **GUARDS[case]})


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_run(jax_dropout_off):  # noqa: F811
    """The JAX start state at tiny widths and global batch 4, its style
    draw, and its G then D step on a 2-device mesh."""
    jhp = tiny_hp(batch_size=B)
    batch = synth_batch(jhp, B=B)
    state, gen, disc, g_tx, d_tx = jax_create_state(
        jhp, jax.random.PRNGKey(0), tuple(batch))
    g_step, d_step, _ = jax_make_steps(jhp, gen, disc, g_tx, d_tx)
    style = JaxRun.style(types.SimpleNamespace(gen=gen, batch=batch), state)
    mesh = jax_make_mesh((2,))
    m_state = jax_shard_state(state, mesh)
    m_batch = jax_shard_batch(batch, mesh)
    j_state, j_gm, (j_mel, j_len) = jax.jit(g_step)(
        m_state, m_batch, jnp.float32(G_LR), jnp.float32(ATTN_W))
    j_state, j_dm = jax.jit(d_step)(
        j_state, m_batch.mels, m_batch.output_lengths, j_mel, j_len,
        jnp.float32(D_LR))
    one, _, (o_mel, o_len) = jax.jit(g_step)(
        state, batch, jnp.float32(G_LR), jnp.float32(ATTN_W))
    one, _ = jax.jit(d_step)(one, batch.mels, batch.output_lengths, o_mel,
                             o_len, jnp.float32(D_LR))
    return types.SimpleNamespace(
        jhp=jhp, hp=port_hp(jhp), start=np_tree(state), style=style,
        batch=np_tree(tuple(batch)), state=j_state, single=one,
        metrics={k: float(v) for k, v in {**j_gm, **j_dm}.items()})


# assert_states_match's tolerances.
STATE_TOL = dict(moment_tol=1e-5, param_rtol=STEP_TOL["rtol"],
                 param_atol=STEP_TOL["atol"], floor=1e-4, noise_tol=1e-6,
                 stats_tol=1e-6)


# Against JAX's mesh step: the moments at 3 times STATE_TOL's, and pinned
# bounds for the tensors whose float32 noise JAX's own mesh and
# single-device steps put further apart (module docstring): their moments
# at 5 times STATE_TOL's, D's first conv's values at twice STATE_TOL's, the
# BatchNorm-fed bias's noise at 2e-6 of the largest first moment.
MESH_MOMENT_TOL = 5 * STATE_TOL["moment_tol"]
MESH_PARAM_TOL = dict(param_rtol=2 * STATE_TOL["param_rtol"],
                      param_atol=2 * STATE_TOL["param_atol"])
MESH_BIAS_NOISE_TOL = 2e-6
MESH_NOISY = {
    **dict.fromkeys(("G embedding", "G encoder.convs.0.conv.weight",
                     "G encoder.convs.1.conv.weight",
                     "G encoder.lstm_fw.w_hh",
                     "G postnet.convs.0.conv.weight"),
                    {"moment_tol": MESH_MOMENT_TOL}),
    "G postnet.convs.0.conv.bias": {"noise_tol": MESH_BIAS_NOISE_TOL},
    "D convs.0.conv.weight": MESH_PARAM_TOL}
MESH_TOL = dict(STATE_TOL, moment_tol=3 * STATE_TOL["moment_tol"],
                tensor_tol=MESH_NOISY)


@pytest.fixture(scope="module")
def cluster(jax_run, tmp_path_factory):
    """Both ranks' results (the worker's scenarios), in a directory."""
    root = tmp_path_factory.mktemp("data_parallel")
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({
            "hp": jax_run.jhp.as_dict(), "state": jax_run.start,
            "batch": jax_run.batch, "style": jax_run.style,
            "lr": {"g": G_LR, "d": D_LR, "attn": ATTN_W},
            "guards": [guard_hp(case).as_dict()
                       for case in range(len(GUARDS))],
            "loop_hp": loop_tiny_hp(**LOOP_OVER).as_dict()}, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(rank), str(root), REPO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    return root


def port_state(jax_run, payload=None):
    """A port state from the JAX start state, dropout off; then the
    checkpoint payload at ``payload``, when given."""
    state, G, D, g_tx, d_tx = train_state_from_jax(jax_run.start, jax_run.hp,
                                                   device="cpu")
    disable_dropout(G)
    disable_dropout(D)
    if payload is not None:
        CheckpointManager(os.path.dirname(payload)).restore(payload, state)
    return state, make_train_steps(jax_run.hp, G, D, g_tx, d_tx)


def tensors(payload):
    """Every model and optimizer tensor of a checkpoint payload, by name
    (the random generators' states are each rank's own)."""
    p = torch.load(payload, weights_only=True)
    out = {f"{side}.{k}": v for side in ("g_state", "d_state")
           for k, v in p[side].items()}
    for side in ("g_opt_state", "d_opt_state"):
        for m in ("mu", "nu"):
            out.update({f"{side}.{m}.{k}": v for k, v in p[side][m].items()})
    return p["step"], out


def test_two_rank_steps_match_jax_mesh_and_one_process(jax_run, cluster):
    """Each rank's state after one G and one D step against JAX's step on
    a 2-device mesh and against the port's one-process step on the global
    batch; the metrics against JAX's."""
    one, (g_step, d_step, _) = port_state(jax_run)
    batch = to_device(Batch(*jax_run.batch), "cpu")
    one, _, (mel, lens) = g_step(one, batch, G_LR, ATTN_W,
                                 style=torch.from_numpy(jax_run.style))
    one, _ = d_step(one, batch.mels, batch.output_lengths, mel, lens, D_LR)
    mesh, single = (train_state_from_jax(np_tree(s), jax_run.hp, "cpu")[0]
                    for s in (jax_run.state, jax_run.single))
    compare_states(mesh, single, what="JAX's mesh step vs its single-device "
                   "step", **MESH_TOL)
    for rank in (0, 1):
        state, _ = port_state(jax_run, str(cluster / f"rank{rank}.steps.ckpt"))
        assert state.step == 2
        compare_states(state, mesh, what=f"rank {rank} vs JAX's mesh step",
                       **MESH_TOL)
        compare_states(state, one, what=f"rank {rank} vs one process",
                       **STATE_TOL)
        with open(cluster / f"rank{rank}.steps.json") as f:
            metrics = json.load(f)
        for k in G_METRICS + D_METRICS:
            if k != "discriminator_loss":
                rel_close(metrics[k], jax_run.metrics[k], 1e-5, k)
        d_loss_close(metrics, jax_run.metrics, 1e-5)


def test_both_ranks_hold_the_same_state_and_metrics(cluster):
    """BatchNorm running statistics, parameters and Adam moments equal
    bit for bit on both ranks, and so are the metrics."""
    (s0, t0), (s1, t1) = (tensors(str(cluster / f"rank{r}.steps.ckpt"))
                          for r in (0, 1))
    assert s0 == s1 == 2 and t0.keys() == t1.keys()
    assert any("running_mean" in k for k in t0)
    for k in t0:
        assert torch.equal(t0[k], t1[k]), k
    m0, m1 = (json.loads((cluster / f"rank{r}.steps.json").read_text())
              for r in (0, 1))
    assert m0 == m1


@pytest.mark.parametrize("case", range(len(GUARDS)))
def test_group_guards_raise_as_jax(cluster, tmp_path, monkeypatch, case):
    """Both ranks raise the ValueError that the JAX loop raises in a
    2-process run (its ``jax.process_count()`` patched to 2); a mesh
    larger than the group raises the port's."""
    messages = [json.loads((cluster / f"rank{r}.guards.json").read_text())
                [case] for r in (0, 1)]
    assert messages[0] == messages[1] and messages[0] is not None
    if GUARDS[case].get("mesh_shape") == [4]:
        assert "(4,) has 4 devices but the process group has 2" \
            in messages[0]
        return
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError) as j_err:
        jax_loop.train(str(tmp_path), None, False,
                       guard_hp(case),
                       "synthetic", logger=JaxLogger(None, quiet=True))
    assert messages[0] == str(j_err.value)


def test_only_the_chief_writes(cluster):
    """The chief's output directory holds its checkpoints and metrics;
    rank 1's was never made, nor its guard runs'."""
    chief = os.listdir(cluster / "rank0.run")
    assert any(n.endswith(".ckpt") for n in chief), chief
    assert any(n.endswith(".metrics.jsonl") for n in chief), chief
    assert not os.path.exists(cluster / "rank1.run")
    assert not os.path.exists(cluster / "rank1.guard")


def test_resume_continues_every_ranks_random_streams(cluster):
    """Dropout on, noise on: each step of the rerun resumed at 3 starts
    from the same dropout and noise generator states as the same step of
    an uninterrupted run to 7, on both ranks, and the ranks draw apart.
    (The resumed run's states differ from the uninterrupted run's: a
    resume restarts the loader's epoch and empties the fake buffer, as the
    JAX loop's does.)"""
    streams = [json.loads((cluster / f"rank{r}.streams.json").read_text())
               for r in (0, 1)]
    for s in streams:
        assert sorted(s["resumed"], key=int) == [str(i) for i in range(7)]
        assert s["resumed"] == s["uninterrupted"]
    for i in range(7):
        assert streams[0]["resumed"][str(i)] != streams[1]["resumed"][str(i)]
    assert not os.path.exists(cluster / "rank1.whole")


def test_resume_seen_by_the_chief_alone_reaches_both_ranks(cluster):
    """The rerun to 7 resumed at 3 from the chief's checkpoint on both
    ranks (a rank that had started afresh would have stepped 7 times from
    the initial state): the same iteration, step and state."""
    runs = [json.loads((cluster / f"rank{r}.loop.json").read_text())
            for r in (0, 1)]
    for r in runs:
        assert r["3"] == {"iteration": 3, "step": 3}
        assert r["7"] == {"iteration": 7, "step": 7}
    for it in (3, 7):
        (s0, t0), (s1, t1) = (tensors(str(cluster / f"rank{r}.loop{it}.ckpt"))
                              for r in (0, 1))
        assert s0 == s1 == it
        for k in t0:
            assert torch.equal(t0[k], t1[k]), (it, k)
