"""Policy pieces copied from ``cilium_tpu/policy``: the HTTP rule of
``api.py`` and the r2d2 and HTTP halves of ``invariance.py``."""
