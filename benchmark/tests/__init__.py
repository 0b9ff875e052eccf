"""CPU tests of the benchmark; card-only ones carry the ``cuda`` marker."""
