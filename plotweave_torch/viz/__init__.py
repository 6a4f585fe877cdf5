"""Visualization: stage previews and the stream simulator.

Copy of ``plotweave/viz/__init__.py``; the port imports nothing of ``plotweave``.
"""
