"""Identification scaling (port of scripts/gan_factorial_study.py): does the
latent code survive a PRODUCT space?

``data.toy.build_factorial_corpus`` hides two independent bits on disjoint
bands (A = [4.0, 4.8] kHz, B >= 5.4 kHz; 4 joint modes). Each arm is
scored for:

  * SCALING — the random-style (N x M) grid
    (``eval.sampling.attribution_level_grid``), per-band attribution + the
    4-way joint attribution (``eval.mode_study.attribution_grid_stats`` /
    ``attribution_grid_stats_multi``);
  * COVERAGE — which joint mode each trained code cell commits to
    (``eval.mode_study.code_mode_coverage``) on a ``coded_style`` decode
    grid with shared nuisance draws;
  * DISENTANGLEMENT — which band each code dim moves
    (``eval.mode_study.code_binding_stats``).

Writes ``<out>/<variant>[_s<seed>]/factorial_study.json``.

Usage:
  python -m gantron_tpu_torch.scripts.gan_factorial_study --variant bit4 \
      --seed 0 [-o DIR] [--device cpu]
"""

import argparse
import json
import os

from gantron_tpu_torch.scripts._study_common import (NOISE_STUDY,
                                                     add_device_argument,
                                                     arm_dir, corpus_dir,
                                                     default_root,
                                                     device_label,
                                                     print_launches,
                                                     study_hparams,
                                                     study_sequence, train_arm)

_BIT_WARM = {
    "adversarial_rollouts": True,
    "style_reconstruction_weight": 10.0,
    "diversity_weight": 1.0,
    "diversity_cap": 0.9,
    "identification_warmup": 1000,
    # The shipped endpoint includes the collapse-rescue controller
    # (docs/TRAINING_EVIDENCE.md "Closed-loop rescue"); its ceiling was
    # calibrated on the single-bit corpora.
    "diversity_rescue_ceiling": 8.3,
    "validation_sample_diversity": 8,
}

VARIANTS = {
    # One 4-level code dim: the product space as a flat categorical.
    "bit4": dict(_BIT_WARM, style_code_dims=1, style_code_levels=4),
    # Two 2-level code dims: covering the product space needs each dim to
    # take one bit.
    "bit2x2": dict(_BIT_WARM, style_code_dims=2, style_code_levels=2),
    # Underparameterized: one 2-level dim facing two hidden bits.
    "bit1": dict(_BIT_WARM, style_code_dims=1, style_code_levels=2),
    # Subset redraw (config.py diversity_subset_redraw): single-dim pairs
    # that owe the full cap on their own.
    "bit2x2_subset": dict(_BIT_WARM, style_code_dims=2, style_code_levels=2,
                          diversity_subset_redraw=True),
    # Modularity arm (config.py code_modularity_weight).
    "bit2x2_mod": dict(_BIT_WARM, style_code_dims=2, style_code_levels=2,
                       diversity_subset_redraw=True,
                       code_modularity_weight=1.0),
    # Additivity arm (config.py code_additivity_weight).
    "bit2x2_add": dict(_BIT_WARM, style_code_dims=2, style_code_levels=2,
                       diversity_subset_redraw=True,
                       code_additivity_weight=1.0),
    # Reward-shaped binding (config.py code_orthogonal_reward).
    "bit2x2_ortho": dict(_BIT_WARM, style_code_dims=2, style_code_levels=2,
                         diversity_subset_redraw=True,
                         code_orthogonal_reward=True),
    # Factor-aware rescue, the historical REDRAW actuator (config.py's
    # default is "recon").
    "bit2x2_rescue": dict(_BIT_WARM, style_code_dims=2, style_code_levels=2,
                          diversity_subset_redraw=True,
                          factor_rescue_floor=2.18,
                          factor_rescue_actuator="redraw"),
    # Factor-aware rescue with the recon actuator.
    "bit2x2_rescue_q": dict(_BIT_WARM, style_code_dims=2,
                            style_code_levels=2,
                            diversity_subset_redraw=True,
                            factor_rescue_floor=2.18,
                            factor_rescue_actuator="recon"),
    # The MSE identification floor.
    "nogan": {"d_freq": 0, "disc_warmp_up": 0},
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="bit4")
    parser.add_argument("-o", "--output",
                        default=default_root("factorialstudy"))
    parser.add_argument("--iterations", type=int, default=3000)
    parser.add_argument("--n_utts", type=int, default=200)
    parser.add_argument("--n_styles", type=int, default=16)
    parser.add_argument("--n_dropout", type=int, default=8)
    parser.add_argument("--code_draws", type=int, default=8,
                        help="nuisance draws per code cell for the "
                             "coverage/binding grid")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hparams", type=str, default=None)
    parser.add_argument("--analyze_only", action="store_true")
    add_device_argument(parser)
    return parser.parse_args(argv)


def hparams_for(args, train_list, val_list):
    return study_hparams(args.iterations, dict(
        NOISE_STUDY, seed=5321 + args.seed,
        training_files=[train_list], validation_files=[val_list]),
        VARIANTS[args.variant], args.hparams)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from gantron_tpu_torch.data.toy import (MODEBAND_SCORE, TEXBAND_SCORE,
                                            build_factorial_corpus)
    from gantron_tpu_torch.eval.mode_study import (
        attribution_grid_stats, attribution_grid_stats_multi, band_channels,
        code_binding_stats, code_mode_coverage, compute_real_anchors,
        hiband_level, joint_mode_grid)
    from gantron_tpu_torch.eval.sampling import (attribution_level_grid,
                                                 coded_style)
    from gantron_tpu_torch.utils.device import derive_seed, generator
    from gantron_tpu_torch.utils.loading import load_generator

    corpus_root = corpus_dir(args.output, args.seed)
    os.makedirs(corpus_root, exist_ok=True)
    wav_dir, train_list, val_list, bits = build_factorial_corpus(
        corpus_root, n_utts=args.n_utts, seed=args.seed)
    hp = hparams_for(args, train_list, val_list)

    out = arm_dir(args.output, args.variant, args.seed)
    iteration, train_seconds, final_val, ckpt_path = train_arm(
        out, args.variant, hp, wav_dir, args.analyze_only, args.device)

    ch_a = band_channels(hp, *MODEBAND_SCORE)
    ch_b = band_channels(hp, TEXBAND_SCORE)
    anchors_a = compute_real_anchors(
        train_list, wav_dir, {n: ab[0] for n, ab in bits.items()}, hp,
        channels=ch_a, device=args.device)
    anchors_b = compute_real_anchors(
        train_list, wav_dir, {n: ab[1] for n, ab in bits.items()}, hp,
        channels=ch_b, device=args.device)

    model = load_generator(ckpt_path, hp, args.device)
    device = model.device
    seq = study_sequence()

    # --- SCALING: random-style (N styles) x (M dropout) grid scored on
    # BOTH bands from the SAME decodes — per-band binary attribution +
    # 4-way joint attribution.
    grid = attribution_level_grid(model, hp, seq, [ch_a, ch_b],
                                  n_styles=args.n_styles,
                                  n_dropout=args.n_dropout, seed=args.seed)
    levels_a, levels_b = grid[:, :, 0], grid[:, :, 1]
    attribution_a = attribution_grid_stats(levels_a, anchors_a["midpoint"])
    attribution_b = attribution_grid_stats(levels_b, anchors_b["midpoint"])
    joint = attribution_grid_stats_multi(
        joint_mode_grid(levels_a, levels_b,
                        anchors_a["midpoint"], anchors_b["midpoint"]), 4)

    # --- COVERAGE + DISENTANGLEMENT: decode every trained code cell with
    # shared nuisance draws (the coded_style serving grid) and score which
    # joint mode each cell commits to and which band each code dim moves.
    code_dims = int(hp.style_code_dims or 0)
    code_levels = int(hp.style_code_levels or 0)
    coverage = binding = None
    if code_dims > 0 and code_levels >= 2:
        S = args.code_draws
        cells = np.stack(np.meshgrid(
            *[np.arange(code_levels)] * code_dims,
            indexing="ij")).reshape(code_dims, -1).T  # (n_cells, code_dims)
        n_cells = cells.shape[0]
        nuis = torch.rand((S, 1, hp.noise_size), device=device,
                          generator=generator(device,
                                              derive_seed(77 + args.seed)))
        style = coded_style(None, n_cells * S, hp.noise_size,
                            np.repeat(cells, S, axis=0), code_dims,
                            code_levels,
                            nuisance=nuis.repeat(n_cells, 1, 1))  # cell-major
        text = torch.as_tensor(seq, device=device).expand(n_cells * S, -1)
        cell_out = model.infer(
            text, style, None, None, hp.max_decoder_steps,
            generator=generator(device, derive_seed(77 + args.seed, 1)))
        mels, lens = cell_out[1].cpu().numpy(), cell_out[4].cpu().numpy()
        lv = np.array([
            (hiband_level(mels[i, :, : max(int(lens[i]), 2)], ch_a),
             hiband_level(mels[i, :, : max(int(lens[i]), 2)], ch_b))
            for i in range(mels.shape[0])])  # (n_cells*S, 2)
        cell_levels = lv.reshape(n_cells, S, 2)
        cell_modes = joint_mode_grid(
            cell_levels[..., 0], cell_levels[..., 1],
            anchors_a["midpoint"], anchors_b["midpoint"])
        coverage = code_mode_coverage(cell_modes, 4)
        coverage["code_cells"] = cells.tolist()
        binding = code_binding_stats(cell_levels, cells)

    result = {
        "variant": args.variant,
        "hparams": dict(VARIANTS[args.variant]),
        "hparams_override": args.hparams,
        "iterations": iteration,
        "train_seconds": train_seconds,
        "seed": args.seed,
        "final_validation": final_val,
        "anchors_a": anchors_a,
        "anchors_b": anchors_b,
        "attribution_a": attribution_a,
        "attribution_b": attribution_b,
        "attribution_joint": joint,
        "coverage": coverage,
        "binding": binding,
        "n_utts": args.n_utts,
        "analyze_only": args.analyze_only,
        "device": device_label(args.device),
    }
    with open(os.path.join(out, "factorial_study.json"), "w") as f:
        json.dump(result, f, indent=2)
    brief = dict(result)
    for k in ("anchors_a", "anchors_b"):
        brief.pop(k)
    for k in ("attribution_a", "attribution_b"):
        brief[k] = {kk: vv for kk, vv in result[k].items()
                    if kk not in ("level_grid", "per_style_hi_counts")}
    brief["attribution_joint"] = {
        kk: vv for kk, vv in joint.items()
        if kk not in ("per_style_mode_counts",)}
    print(json.dumps(brief, indent=2))
    print_launches()
    return result


if __name__ == "__main__":
    main()
