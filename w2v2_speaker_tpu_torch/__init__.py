"""PyTorch/CUDA port of ``w2v2_speaker_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference. This package imports ``torch``
and never ``jax``, ``flax``, ``optax`` or anything of ``w2v2_speaker_tpu``;
it keeps its own copies of the host code it needs. Module names follow the
JAX package's. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (as the CPU tests do); without a card and without that
request they raise.

Slice 1 (this package so far) is the eval-only speaker-embedding path:
wav2vec2 -> masked mean pooling -> FC head, with every attention call on the
card going through the hand-written kernel in ``csrc/``.
"""
