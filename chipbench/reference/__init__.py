"""The plain references the benchmark holds the program to, in fp32
PyTorch: the dense GQA/MHA decoder (``decoder.py``, the ``dense`` family's,
which also holds ``exact_fp32`` and ``fp8_round`` for any family's
reference). A family's module (``families/<family>.py``) returns its
reference. None imports anything of the program or takes anything the
program made."""
