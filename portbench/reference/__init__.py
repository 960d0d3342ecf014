"""The plain reference that decides ``correct``: plain PyTorch worked out
from the COO arrays that the benchmark generated and handed to the program.
It imports nothing of the program, nor JAX or the JAX package, and takes
nothing the program built.

One module a reference, found by name: ``<semiring>.py`` for the
``spmv`` driver (``product``, ``rel_err``), ``<algorithm>.py`` for the
``solve`` driver (``prepare``, ``solve``); the drivers say what each
returns."""
