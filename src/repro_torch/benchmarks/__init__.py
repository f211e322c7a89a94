"""The paper's benchmarks on the port (the JAX package's ``benchmarks/``,
one at a time as they are ported)."""
