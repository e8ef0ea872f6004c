"""One driver per kind of traffic (``benchmark/kinds/<kind>.py``), each
with ``setup(env)``, ``window(env, state)`` and ``close(env, state)``."""
