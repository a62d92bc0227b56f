"""Fault tolerance: durable checkpoint files (``checkpoint.py``),
deterministic fault injection (``faults.py``) and the retry policy
(``retry.py``).  The rest of the JAX package's ``resilience/`` (the
supervisor, elastic gangs, the device-pool arbiter) is not ported yet."""
