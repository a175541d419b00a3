"""Flash attention (the JAX package's K4): the CUDA kernel's wrapper and
plain version (``flash_attention``), the oracle (``ref``) and the GQA entry
(``ops``)."""
