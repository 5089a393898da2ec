"""Support modules copied from ``cilium_tpu/utils`` (jax-free): ``flowdebug``,
``metrics`` and the one option name ``flowlog`` reads."""
