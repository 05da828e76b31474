"""The study campaigns of the PyTorch port (port of the repository's
``scripts/``): each module runs as ``python -m
gantron_tpu_torch.scripts.<name>``, on the CUDA card unless ``--device cpu``
is given, with the JAX script's name, arguments, variants and output files.

* ``run_study``: the campaign runner (``--list``, ``--arm``, ``--queue``,
  ``progress.log``, the one-shot ``STOP`` file).
* The studies: ``gan_mode_study``, ``gan_texture_study``,
  ``gan_composed_study``, ``gan_factorial_study``, ``gan_continuous_study``,
  ``gan_vector_study`` and ``evidence_run``. Each synthesizes its corpus
  from a seed, trains the ≈ 96-dim study model (``_study_common``) and
  scores the trained generator.
* The post-hoc tools on their checkpoints: ``mode_attribution``,
  ``calibrate_knob``, ``continuous_extrapolation``, ``vector_unmix``,
  ``calibrate_factor_sensor`` and ``calibrate_rescue_floor``.

Importing a module runs nothing: each does its work in ``main(argv)``.
``scripts/summarize_*.py`` at the repository root read these outputs as
they read the JAX package's.
"""
