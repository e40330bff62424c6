"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on the H100.

``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` through
``repro_torch.launch.serve.DecodeServer`` and prints one JSON line.

Everything here that is particular to one configuration, traffic mix, cell
or metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json`` (the correctness limit and the readings it was set
from) and ``metrics/<metric>.py`` (a reader with ``read(run)``). The
yardstick is kept here and never in the program: the peaks and work counts
(``work.py``), the seeded weights and prompts (``weights.py``), the plain
fp32 reference (``reference/``), the comparison that decides ``correct``
(``correct.py``) and the reduction of the profiler's trace (``trace.py``).
Only ``program.py`` imports the port.
"""
