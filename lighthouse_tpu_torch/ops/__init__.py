"""Batched BLS12-381 arithmetic on torch tensors, and the CUDA kernels'
wrappers.

Layers, bottom up: ``mont_mul`` (kernel K1 and its plain version),
``field`` (Fp), ``tower`` (Fp2/Fp6/Fp12), ``points`` (G1/G2 group law),
``pairing`` (Miller loop, final exponentiation).
"""
