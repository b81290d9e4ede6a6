"""ctts_tpu_torch — the PyTorch/CUDA port of ctts_tpu's serving path.

The JAX package `ctts_tpu` stays the reference; this package runs the
batch-serving path (BatchSynthesizer → native plan lowering →
SynthesisCore → WSOLA for speed ≠ 1.0 → packed int16 out) on an NVIDIA
Hopper card or split over several (parallel/mesh.py), across processes
over torch.distributed (parallel/multihost.py), with the Pallas kernels
of that path rewritten by hand in CUDA C++ (ctts_tpu_torch/csrc). It
stands alone: torch, numpy and its
own copies of the host modules (text, plan compiler, db, oracle, the
native runtime) — nothing of ctts_tpu and never jax.
"""
