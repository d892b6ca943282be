"""Hand-written CUDA kernels for Hopper (``sm_90a``).

Sources live in ``csrc/`` (one shared library per ``.cu`` file, plain C
entry points); :mod:`.build` compiles them with ``nvcc`` at first use
and loads them with ``ctypes``. Nothing is compiled at import time.
"""
