"""Fault tolerance: durable checkpoint files (``checkpoint.py``) and
deterministic fault injection (``faults.py``).  The rest of the JAX
package's ``resilience/`` (retries, the supervisor, elastic gangs) is not
ported yet."""
