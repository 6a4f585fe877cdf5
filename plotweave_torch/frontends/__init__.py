"""Alternate input front-ends: G-code and SVG → plotter streams.

Copy of ``plotweave/frontends/__init__.py``; the port imports nothing of ``plotweave``.
"""
