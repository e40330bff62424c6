"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on the H100.

``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` through
``repro_torch.launch.serve.DecodeServer`` and prints one JSON line.

Everything here that is particular to one configuration, traffic mix, cell,
metric or model family is a file of its own, found by the name
``BENCHMARK.json`` or a configuration file gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``, ``cells/<cell>.json``
(the correctness limit and the readings it was set from),
``metrics/<metric>.py`` (a reader with ``read(run)``) and
``families/<family>.py`` (a configuration's sizes, weights, reference, work
counts and the port's model of it; ``families/__init__.py`` gives the
interface). The yardstick is kept here and never in the program: the peaks
(``work.py``) and each family's work counts, the seeded weights and prompts
(``weights.py``), the plain fp32 references (``reference/``), the
comparison that decides ``correct`` (``correct.py``) and the reduction of
the profiler's trace (``trace.py``). Only ``program.py`` imports the port.
"""
