"""lighthouse_tpu_torch: the PyTorch/CUDA port of lighthouse_tpu's device layer.

Batch BLS12-381 signature-set verification on an NVIDIA H100. The package
imports torch and numpy, never jax and nothing of ``lighthouse_tpu``: the
JAX-free oracle modules it needs live here as copies under ``crypto/bls``.

Layout mirrors the JAX package so each module's counterpart is easy to find:
``crypto/bls/`` (host oracle), ``ops/`` (field, tower, group law, pairing,
and the hand-written CUDA kernels' wrappers), ``torch_backend.py`` (the
``verify_signature_sets`` entry point). Importing the package builds and
loads nothing; CUDA sources under ``csrc/`` compile at first use.
"""
