"""ctts_tpu_torch — the PyTorch/CUDA port of ctts_tpu's serving path.

The JAX package `ctts_tpu` stays the reference; this package runs the
speed-1.0 batch-serving path (BatchSynthesizer → native plan lowering →
SynthesisCore → packed int16 out) on an NVIDIA Hopper card, with the
four Pallas kernels of that path rewritten by hand in CUDA C++
(ctts_tpu_torch/csrc). It imports torch, numpy and the jax-free host
modules of ctts_tpu (text, plan compiler, db, oracle) — never jax.
"""
