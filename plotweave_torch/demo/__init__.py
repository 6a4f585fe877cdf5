"""Procedural demo-stream generators.

Copy of ``plotweave/demo/__init__.py``; the port imports nothing of ``plotweave``.
"""
