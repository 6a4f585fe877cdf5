"""Vector-geometry stages: tracing, scaling, ordering, dedup, planning.

Copy of ``plotweave/vector/__init__.py``; the port imports nothing of ``plotweave``.
"""
