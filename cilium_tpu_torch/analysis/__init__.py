"""Declared protocol tables of the sidecar (``protocols.py``).

A copy of ``cilium_tpu/analysis/protocols.py`` only: the JAX package's
``analysis`` package also holds its static analyser, whose import pulls
JAX, and the port does not carry it.
"""
