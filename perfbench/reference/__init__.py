"""Plain PyTorch reference of GANtron (Tacotron 2 with noise and emotion
conditioning, its conv discriminator, WaveGlow) that decides the benchmark's
``correct``.

It is written from the published models, in float32 with TF32 off, one
operation at a time, and imports nothing of the program under test: it takes
its weights as a dict of tensors that the benchmark makes from the seed and
hands to both sides. Every matrix product and convolution goes through a
``Precision`` (``precision.py``), which rounds the operands for the lower
precision controls.
"""
