"""Typed failures, the retry policy and deadlines of the port.

Ported so far: :mod:`errors`, :mod:`retry` and ``deadline.Deadline``. The
dispatch watchdog, fault injection and the fallback ladder are not ported.
"""
