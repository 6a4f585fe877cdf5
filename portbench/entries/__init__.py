"""The entries: ``entries/<entry>.py`` holds ``Entry(config, mix, seed,
device)`` with ``ring``, ``mpx_per_call``, ``setup()``, ``call(j)`` (the
timed entry on ring input j), ``reference(j, control)``, ``as_output(ref)``
(the reference's answer in the program's form), ``judge(out, ref)`` and
``check(kept) -> ({name: (value, limit)}, calls wrong, [work of each ring
input])``."""
