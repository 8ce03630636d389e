"""The plain reference that decides ``correct``.

numpy and plain torch only: nothing here imports ``jax``, ``dmosopt_tpu``
or ``dmosopt_tpu_torch``. It works out again, in float64, what the program
derived (objective values, the non-dominated front, the GP's marginal
likelihood and posterior mean) and reads the program's outputs only to
judge them.
"""
