"""The work each piece of an iteration needs, from the cell's shapes and
the run's counts (evaluations, solves, PCG iterations, live graph slots):
the same whatever implements it, so a fused or removed kernel does not
change the yardstick.  Bytes count each input read once and each output
written once; operations are float32 operations."""
