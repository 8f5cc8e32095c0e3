"""Frozen input generators (copies of the port's own, kept here so a change
to the program cannot change the benchmark's inputs)."""
