"""Hand-written CUDA kernels for the compute hot spots, built from
``repro_torch/csrc`` on first use (``kernels.build``). Each kernel's wrapper
keeps a plain torch version beside it for CPU tensors and counts its
launches.

  * ``block_matmul`` — the §2 local block product (batched);
  * ``flash_attention`` — online-softmax attention for the model's
    prefill and eval-loss forward;
  * ``runtime.backends.cuda_fused.reduce_rounds`` / ``combine_rows`` — the
    table-driven §4 all-reduce rounds and §2 combine groups.
"""
