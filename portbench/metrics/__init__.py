"""The metrics' readers: ``metrics/<metric>.py`` holds ``read(run)``, the
metric's value from a :class:`portbench.harness.Run`, or None where the run
has nothing to read (the harness then leaves the metric out)."""
