"""Shared code of the benchmark: the run's frame, the generators, the
arithmetic of peaks and rooflines, the trace reduction and the two
drivers (tiled evaluation, training epochs).  It copies what it needs
and imports nothing of the program but its public entry points, which
the drivers call."""
