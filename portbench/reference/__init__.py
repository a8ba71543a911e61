"""Plain PyTorch and NumPy references that decide a run's ``correct``.

Nothing here imports the program under test, JAX or the JAX package. The
references take the inputs the benchmark makes (weights, clips, galleries,
queries) and work out again whatever the program derives from them.
"""
