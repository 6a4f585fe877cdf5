"""portbench: the benchmark of ``plotweave_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything of a cell is found by name: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``, which
names the entry's module ``entries/<entry>.py``), each metric's reader
(``metrics/<metric>.py``) and each kernel's count of bytes and operations
(``roofline/<kernel>.py``).  ``reference/`` is the plain reference that
decides ``correct``.
"""
