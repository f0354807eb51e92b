"""Admission outcomes of the serving engine (the exception classes of
the JAX ``serve/admission.py``; its degraded ladder is not ported yet)."""


class QueueFull(Exception):
    """Admission rejected the request: the bounded queue is at capacity."""


class EngineStopped(Exception):
    """The engine is not accepting work (not started, or stopped)."""
