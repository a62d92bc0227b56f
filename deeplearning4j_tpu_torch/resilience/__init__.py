"""Fault tolerance: durable checkpoint files (``checkpoint.py``).  The
rest of the JAX package's ``resilience/`` (fault injection, the
supervisor, elastic gangs) is not ported yet."""
