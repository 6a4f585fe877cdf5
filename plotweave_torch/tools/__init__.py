"""Standalone tools: colour analysis and layer splitting (copies of ``plotweave/tools``)."""
