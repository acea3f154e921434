"""A traffic mix names its driver here: ``run(ctx)`` serves or trains one
cell once and returns its end-to-end numbers, the traced record and the
comparison with the reference."""
