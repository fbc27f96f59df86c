"""The benchmark of ``qtpu_torch`` on one NVIDIA H100: data-driven cells
(``BENCHMARK.json`` at the checkout's root, files under this folder found
by name), a traffic driver a cell, a reader a per-layer metric, and a
plain reference that decides ``correct``.  ``python3 -m qkdbench.run``
runs one cell; ``README.md`` says how to add one."""
