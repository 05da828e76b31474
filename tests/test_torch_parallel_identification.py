"""The identification G step over two processes: the composed study's
"full" arm (``ARM_A``: rollouts scored by D, InfoGAN reconstruction of a
1-dim 2-level code, the saturating diversity pair) in a two-rank gloo
group on the CPU (tests/torch_parallel_worker.py's ``ident`` scenario),
against the port's one-process step and the JAX package's step on a
2-device mesh, from one JAX state (gate pinned, dropout off).

Global batch 4, 2 rows a rank. The teacher-forced style and the rollout's
draws are given for the global batch; each rank takes its rows
(``train/step.py`` ``_local_rows``). Every rank decodes as many rollout
steps as the batch has mel frames, and D's loss is a mean of per-sample
means, so equal shards give the global step.

Tolerances: against the one-process step ``STATE_TOL`` (test_torch_train's
``assert_states_match``); against JAX's mesh step ``MESH_TOL`` with the
moments at ``ROLLOUT_MOMENT_TOL``'s 1e-4 of each tensor's largest (the
rollout's float32 sums, test_torch_identification.py), which is above every
bound ``MESH_TOL`` pins. In both the conv biases before a training-mode
BatchNorm are held as every other parameter: the rollout's encoder and
postnet run on running statistics, which gives them a gradient.
"""

import json
import pickle

import pytest

import jax.numpy as jnp
import torch

from gantron_tpu.parallel import make_mesh as jax_make_mesh
from gantron_tpu.parallel import shard_batch as jax_shard_batch
from gantron_tpu.parallel import shard_state as jax_shard_state
from gantron_tpu_torch.train.checkpoint import CheckpointManager
from gantron_tpu_torch.train.state import compare_states
from gantron_tpu_torch.utils.jax_weights import train_state_from_jax
from test_torch_identification import (ARM_A, B, ROLLOUT_MOMENT_TOL,
                                       IdentRun, g_step_both, rollout_draws,
                                       tf_style)
from test_torch_parallel_steps import MESH_TOL, STATE_TOL, run_ranks, tensors
from test_torch_train import (ATTN_W, D_LR, G_LR,  # noqa: F401
                              jax_dropout_off, np_tree, rel_close)
from torch_threads import one_torch_thread  # noqa: F401

IDENT_STATE_TOL = dict(STATE_TOL, noise_tol=None)
IDENT_MESH_TOL = dict(MESH_TOL, moment_tol=ROLLOUT_MOMENT_TOL, noise_tol=None,
                      tensor_tol=None)


@pytest.fixture(scope="module")
def ident(jax_dropout_off):  # noqa: F811
    """ARM_A's JAX state at global batch 4, its G step on one device with
    the port's one-process step beside it (g_step_both), and its G step on
    a 2-device mesh."""
    run = IdentRun(**ARM_A)
    assert run.batch.text.shape[0] == B == 4
    p_state, (g_step, _, _) = run.port()
    _, _, _, one, one_m, _ = g_step_both(run, p_state, g_step)
    mesh = jax_make_mesh((2,))
    j_mesh, j_m, _ = run.g_step(
        jax_shard_state(run.state, mesh), jax_shard_batch(run.batch, mesh),
        jnp.float32(G_LR), jnp.float32(ATTN_W), jnp.float32(1.0))
    return run, one, one_m, j_mesh, {k: float(v) for k, v in j_m.items()}


@pytest.fixture(scope="module")
def ranks(ident, tmp_path_factory):
    """Both ranks' states and metrics after the G step."""
    run = ident[0]
    root = tmp_path_factory.mktemp("parallel_identification")
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({
            "lr": {"g": G_LR, "d": D_LR, "attn": ATTN_W},
            "ident": {
                "hp": run.jhp.as_dict(), "state": np_tree(run.state),
                "batch": np_tree(tuple(run.batch)),
                "style": tf_style(run.gen, run.state.rng, B),
                "draws": rollout_draws(run.hp, run.state.rng, B, run.gen)}},
            f)
    return run_ranks(root)


def rank_state(run, root, rank):
    """A port state of ARM_A's models with the rank's checkpoint
    restored."""
    state = train_state_from_jax(np_tree(run.state), run.hp, device="cpu")[0]
    CheckpointManager(str(root)).restore(str(root / f"rank{rank}.ident.ckpt"),
                                         state)
    return state


def test_two_rank_identification_step_matches_one_process_and_jax_mesh(
        ident, ranks):
    """Each rank's state against the port's one-process step
    (``IDENT_STATE_TOL``) and JAX's mesh step (``IDENT_MESH_TOL``); its
    metrics (the rollout's adversarial loss, the reconstruction loss, the
    diversity ratio among them) within 1e-5 relative of JAX's mesh
    step's."""
    run, one, one_m, j_mesh, j_m = ident
    mesh = train_state_from_jax(np_tree(j_mesh), run.hp, "cpu")[0]
    assert {"rollout_adversarial_loss", "style_reconstruction_loss",
            "style_diversity_ratio"} <= set(j_m)
    for rank in (0, 1):
        state = rank_state(run, ranks, rank)
        assert state.step == 1
        compare_states(state, one, what=f"rank {rank} vs one process",
                       **IDENT_STATE_TOL)
        compare_states(state, mesh, what=f"rank {rank} vs JAX's mesh step",
                       **IDENT_MESH_TOL)
        metrics = json.loads((ranks / f"rank{rank}.ident.json").read_text())
        assert set(metrics) == set(j_m)
        for k in j_m:
            rel_close(metrics[k], j_m[k], 1e-5, k)
            rel_close(metrics[k], one_m[k], 1e-5, k)


def test_both_ranks_hold_the_same_identification_state(ranks):
    """Parameters, Adam moments, BatchNorm running statistics and metrics
    bit-equal on both ranks."""
    (s0, t0), (s1, t1) = (tensors(str(ranks / f"rank{r}.ident.ckpt"))
                          for r in (0, 1))
    assert s0 == s1 == 1 and t0.keys() == t1.keys()
    for k in t0:
        assert torch.equal(t0[k], t1[k]), k
    m0, m1 = (json.loads((ranks / f"rank{r}.ident.json").read_text())
              for r in (0, 1))
    assert m0 == m1
