"""The plain reference the benchmark holds the program to: a dense GQA/MHA
decoder in fp32 PyTorch (``decoder.py``). It imports nothing of the
program and takes nothing the program made."""
