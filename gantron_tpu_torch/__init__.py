"""GANtron serving in PyTorch and CUDA, ported from the JAX package ``gantron_tpu``.

The module layout mirrors ``gantron_tpu`` so that each counterpart is easy to
find. This package imports ``torch`` and never ``jax`` or ``gantron_tpu``; the
pure-Python pieces it needs (``config``, ``text``, ``audio.filters``,
``data.wav``, ``data.filelists``, ``data.toy``) are its own copies.

Entry points (``tts.Synthesizer``, ``models.Tacotron2``,
``models.waveglow.WaveGlow``, ``audio.MelSpectrogram``,
``data.TextMelDataset``, ``train.loop.train``, and the CLIs
``python -m gantron_tpu_torch.cli.train`` and ``cli.inference_samples``) run
on the CUDA card unless the caller passes ``device="cpu"``. The hand-written
kernels are the int8 weight-streaming matmul of the decoder,
``csrc/qmm.cu``, reached through ``ops.quant.qmm``, and the fused log-mel
featurizer, ``csrc/mel.cu``, reached through ``ops.mel.log_mel``.
"""
