"""ONE parameterized runner for every study campaign of the PyTorch port
(port of scripts/run_study.py).

A campaign arm is ``<study>/<variant>`` where ``<study>`` selects the study
module and ``<variant>`` one of its VARIANTS (or a NAMED_ARMS entry that
bundles a variant with hparams overrides / iteration counts, e.g. the
calibrated-cap arm ``continuous/cont_warm_cap045``).

Usage:
  python -m gantron_tpu_torch.scripts.run_study --list
  python -m gantron_tpu_torch.scripts.run_study --arm continuous/cont_warm \
      --seeds 0 1 2
  python -m gantron_tpu_torch.scripts.run_study --arm factorial/s2_9k -o DIR
  python -m gantron_tpu_torch.scripts.run_study --queue \
      continuous/cont_warm_cap045:0 continuous/cont_warm_cap045:1
  ... [--device cpu] [--n_utts N] [--study_args "--samples 8"]

Arms run SEQUENTIALLY (one card); each gets ``timeout`` seconds (default
7200). Each arm runs ``python -m gantron_tpu_torch.scripts.<study>`` with
``--device`` (default the card), and ``--n_utts`` and the words of
``--study_args`` when given. Progress and per-arm rc go to
<out>/progress.log. Touch <out>/STOP to finish the current arm and stop
the queue (exit code 3; the file is consumed by the next invocation) —
never kill by pattern.

Default output roots are the JAX runner's with ``torch_`` in front, under
the temporary directory (``/tmp/torch_contstudy`` when $TMPDIR is unset).
Two arms of different studies may not share one ``-o``: their corpora
would land in one ``corpus`` directory.
"""

import argparse
import datetime
import os
import re
import shlex
import subprocess
import sys

from gantron_tpu_torch.scripts._study_common import default_root

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PACKAGE = "gantron_tpu_torch.scripts"

# study name -> (module, default output root's name: _study_common.
# default_root gives the directory)
STUDIES = {
    "continuous": ("gan_continuous_study", "contstudy"),
    "factorial": ("gan_factorial_study", "factorialstudy"),
    "mode": ("gan_mode_study", "modestudy"),
    "texture": ("gan_texture_study", "texstudy"),
    "vector": ("gan_vector_study", "vectorstudy"),
    "composed": ("gan_composed_study", "composedstudy"),
    "evidence": ("evidence_run", "evidence"),
}

# Named arms beyond the plain study VARIANTS: bundles of variant +
# overrides behind committed evidence. Each maps to (study, variant, extra
# argv). Plain "<study>/<variant>" arms need no entry here.
NAMED_ARMS = {
    # Range-coverage fix: diversity_cap calibrated AT the measured natural
    # full-range mel-L1 distance of the leveled corpus (0.435 between
    # u=0.05 and u=0.95 same-text renders, vs within-level jitter 0.27 —
    # docs/TRAINING_EVIDENCE.md "Continuous control"). The default cap 0.9
    # sits ABOVE the on-manifold maximum, so the saturating reward never
    # saturates and the knob gain is set by a seed-dependent
    # diversity-vs-fidelity equilibrium (measured coverage 0.23-1.64).
    "continuous/cont_warm_cap045": (
        "continuous", "cont_warm", ["--hparams", "diversity_cap=0.45"]),
    # Does subset s2's partial coverage (0.5 at 6k) complete with more
    # training time? (ROADMAP "s2 9k".)
    "factorial/s2_9k": (
        "factorial", "bit2x2_subset", ["--iterations", "9000"]),
    # The texture frontier: the GP x rollout interaction recovered 54% of
    # history-unpredictable texture at val mel 0.664 (1 seed); map
    # recovery-vs-fidelity over GP strength and D capacity (the
    # reference's 0.001 weight clip is gone under GP, so D width is free
    # to grow).
    "texture/gp3_rollout": (
        "texture", "gp_rollout", ["--hparams",
                                  "gradient_penalty_lambda=3.0"]),
    "texture/gp30_rollout": (
        "texture", "gp_rollout", ["--hparams",
                                  "gradient_penalty_lambda=30.0"]),
    "texture/gp_rollout_d192": (
        "texture", "gp_rollout", ["--hparams", "discriminator_dim=192"]),
    # Capacity-starvation control: if the 0.001 weight clip starved D of
    # variance-statistics capacity, halving D width below the study
    # default should reproduce the starvation (prediction: recovery falls
    # toward the clip-D baseline 0.368).
    "texture/gp_rollout_d48": (
        "texture", "gp_rollout", ["--hparams", "discriminator_dim=48"]),
    # Calibrated diversity cap for the BILEVELED corpus: the measured
    # same-text corner distance is 0.676 +/- 0.011, so the default 0.9
    # sits 1.33x above the on-manifold maximum; cap AT the corner
    # distance (the continuous campaign's recipe).
    "vector/vec_warm_cap068": (
        "vector", "vec_warm", ["--hparams", "diversity_cap=0.68"]),
}


def known_arms():
    """Every ``<study>/<variant>`` arm (read from each study module's
    VARIANTS block, without importing it) plus NAMED_ARMS."""
    arms = {}
    for study, (module, _) in STUDIES.items():
        with open(os.path.join(HERE, module + ".py")) as f:
            src = f.read()
        variants = []
        m = re.search(r"^VARIANTS = \{(.*?)^\}", src, re.S | re.M)
        if m:
            variants = re.findall(r'^    "([^"]+)":', m.group(1), re.M)
        for v in variants:
            arms[f"{study}/{v}"] = (study, v, [])
    arms.update(NAMED_ARMS)
    return arms


def merge_hparams(extra, user_hparams):
    """Combine a named arm's bundled ``--hparams`` with user overrides
    rather than letting argparse keep only the last flag: the user's
    string appends AFTER the bundle, so it wins field-by-field."""
    extra = list(extra)
    if user_hparams and "--hparams" in extra:
        i = extra.index("--hparams")
        user_hparams = extra[i + 1] + "," + user_hparams
        del extra[i:i + 2]
    return extra, user_hparams


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--list", action="store_true",
                        help="print every known arm and exit")
    parser.add_argument("--arm", help="<study>/<variant> or a NAMED_ARMS key")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--queue", nargs="+", default=None,
                        help="arm:seed specs run sequentially "
                             "(e.g. continuous/cont_warm:1)")
    parser.add_argument("-o", "--output", default=None,
                        help="output root (default: the study's canonical "
                             "root)")
    parser.add_argument("--iterations", type=int, default=None)
    parser.add_argument("--hparams", default=None)
    parser.add_argument("--analyze_only", action="store_true")
    parser.add_argument("--timeout", type=int, default=7200,
                        help="seconds per arm")
    parser.add_argument("--device", default=None,
                        help="passed to every arm (its default: the card)")
    parser.add_argument("--n_utts", type=int, default=None,
                        help="passed to every arm: its corpus size")
    parser.add_argument("--study_args", default=None,
                        help="more arguments for every arm, one string "
                             "(e.g. \"--samples 8\")")
    return parser, parser.parse_args(argv)


def main(argv=None):
    parser, args = parse_args(argv)
    arms = known_arms()
    if args.list:
        for name in sorted(arms):
            study, variant, extra = arms[name]
            print(f"{name:40s} -> python -m {PACKAGE}.{STUDIES[study][0]} "
                  f"--variant {variant} " + " ".join(extra))
        return 0

    jobs = []  # (arm_name, seed)
    if args.queue:
        for spec in args.queue:
            name, _, seed = spec.rpartition(":")
            if not name or not seed.lstrip("-").isdigit():
                parser.error(f"malformed queue spec {spec!r} "
                             "(want <study>/<variant>:<seed>)")
            jobs.append((name, int(seed)))
    elif args.arm:
        jobs = [(args.arm, s) for s in args.seeds]
    else:
        parser.error("need --arm, --queue, or --list")

    for name, _ in jobs:
        if name not in arms:
            parser.error(f"unknown arm {name!r} (see --list)")

    def job_root(name):
        study, variant, _ = arms[name]
        # A named arm reuses its base variant's output dir names; give it
        # its own root so e.g. texture/gp3_rollout cannot overwrite
        # texture/gp_rollout results.
        arm_tag = name.split("/", 1)[1]
        root = default_root(STUDIES[study][1])
        if arm_tag != variant:
            root = f"{root}_{arm_tag}"
        return args.output or root

    # An explicit -o must not let two DIFFERENT arms sharing a base
    # variant write into the same checkpoint dirs (silently mislabeled
    # evidence), nor two studies share one corpus dir — refuse up front.
    claimed, studies_of = {}, {}
    for name, _ in jobs:
        study, variant, _ = arms[name]
        key = (job_root(name), study, variant)
        if claimed.setdefault(key, name) != name:
            parser.error(
                f"arms {claimed[key]!r} and {name!r} would share output "
                f"dir {key[0]}/{key[2]}*; drop -o so each named arm gets "
                "its own root, or run them separately")
        if studies_of.setdefault(key[0], study) != study:
            parser.error(
                f"studies {studies_of[key[0]]!r} and {study!r} would share "
                f"the corpus of {key[0]}; drop -o so each study gets its "
                "own root, or run them separately")

    # A STOP file is a one-shot signal: consume any stale one so a new
    # invocation doesn't silently no-op with exit 0.
    for name, _ in jobs:
        stale = os.path.join(job_root(name), "STOP")
        if os.path.exists(stale):
            os.remove(stale)
            print(f"removed stale stop-file {stale}")

    # The arms import this checkout's package from any working directory.
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    failures = 0
    stopped = False
    for name, seed in jobs:
        study, variant, extra = arms[name]
        root = job_root(name)
        os.makedirs(root, exist_ok=True)
        stop = os.path.join(root, "STOP")
        log_path = os.path.join(root, "progress.log")
        if os.path.exists(stop):
            with open(log_path, "a") as log:
                log.write(f"=== STOPPED by {stop}\n")
            print(f"stop-file {stop} present; not starting {name}:{seed}")
            stopped = True
            break
        cmd = [sys.executable, "-m", f"{PACKAGE}.{STUDIES[study][0]}",
               "--variant", variant, "--seed", str(seed), "-o", root]
        extra, hparams = merge_hparams(extra, args.hparams)
        cmd += extra
        if args.iterations is not None:
            cmd += ["--iterations", str(args.iterations)]
        if hparams:
            cmd += ["--hparams", hparams]
        if args.analyze_only:
            cmd += ["--analyze_only"]
        if args.device is not None:
            cmd += ["--device", args.device]
        if args.n_utts is not None:
            cmd += ["--n_utts", str(args.n_utts)]
        if args.study_args:
            cmd += shlex.split(args.study_args)
        stamp = datetime.datetime.now().strftime("%H:%M:%S")
        with open(log_path, "a") as log:
            log.write(f"=== {stamp} {' '.join(cmd)}\n")
            log.flush()
            try:
                rc = subprocess.call(cmd, stdout=log, stderr=log, env=env,
                                     timeout=None if args.timeout <= 0
                                     else args.timeout)
            except subprocess.TimeoutExpired:
                rc = f"timeout>{args.timeout}s"
            stamp = datetime.datetime.now().strftime("%H:%M:%S")
            log.write(f"=== rc={rc} {stamp}\n")
        print(f"{name}:{seed} rc={rc}", flush=True)
        failures += rc != 0
    if stopped:
        return 3  # distinguishable from "all arms ran" for automation
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
