"""The plain float32 reference of the benchmark's configurations.

It imports neither ``jax``, the JAX package nor anything of the program
(``tricolo_tpu_torch``), and takes nothing the program made: the benchmark
hands it the same seeded weights and raw items it hands the program.
``model`` is the forward, ``train`` the compared steps, ``batch`` the
batch assembly worked out again from the raw items, ``precision`` the
control's fp8 rounding.
"""
