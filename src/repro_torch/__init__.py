"""PyTorch and CUDA port of the Swapped Dragonfly collective runtime.

Mirrors the layout of the JAX package: ``core`` (topology, routing, the
paper's four algorithms as one Schedule IR, the simulator), ``runtime``
(lowering to ``CollectiveProgram``s, ``optimize()`` fusion, backends),
``dist`` (device layouts and the cached program getters), ``kernels``
(hand-written CUDA kernels, built on first use), ``configs`` and
``models`` (the dense attention models), ``serve`` (the engine) and
``launch`` (the serving launcher). Imports torch and numpy only.
"""
