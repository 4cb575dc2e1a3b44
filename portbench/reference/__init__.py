"""Plain references the benchmark judges the program against. Each imports
nothing of the program (``gypsum_tpu_torch``) nor of the JAX package."""
