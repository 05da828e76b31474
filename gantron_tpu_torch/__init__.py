"""GANtron serving in PyTorch and CUDA, ported from the JAX package ``gantron_tpu``.

The module layout mirrors ``gantron_tpu`` so that each counterpart is easy to
find. This package imports ``torch`` and never ``jax`` or ``gantron_tpu``; the
pure-Python pieces it needs (``config``, ``text``) are its own copies.

Entry points (``tts.Synthesizer``, ``models.Tacotron2``,
``models.waveglow.WaveGlow``) run on the CUDA card unless the caller passes
``device="cpu"``. The one hand-written kernel of this slice is the int8
weight-streaming matmul of the decoder, ``csrc/qmm.cu``, reached through
``ops.quant.qmm``.
"""
