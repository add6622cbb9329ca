"""The benchmark of ``meshanything_tpu_torch``: see ``README.md``."""
