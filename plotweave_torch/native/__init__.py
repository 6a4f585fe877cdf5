"""Native (C++) runtime: stream encoder + skeleton tracer.

The shared library is compiled on first use (g++ -O3, cached under
``plotweave_torch/_build/``, keyed on a hash of the source and flags).  All entry points have pure-Python fallbacks;
``available()`` reports whether the fast path is active.

Copy of ``plotweave/native/__init__.py``; the port imports nothing of ``plotweave``.
"""

from .loader import available, get_lib

__all__ = ["available", "get_lib"]
