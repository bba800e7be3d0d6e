"""PyTorch/CUDA port of the ``skypilot_tpu`` compute stack.

The JAX package ``skypilot_tpu`` stays the reference; this package mirrors
its module names and public layouts (``[B, S, H, D]`` activations,
``[L, B, Hkv, M, D]`` caches, stacked ``[L, ...]`` weights) and replaces
each Pallas TPU kernel with a CUDA kernel written for Hopper (``sm_90a``).

It imports ``torch`` and never ``jax``, and nothing of ``skypilot_tpu``:
what it needs from there it keeps as its own copy.

Ported so far (serving, with the continuous engine as the replica's
default path, and single-device training):

* ``utils/device.py`` -- device resolution (CUDA unless ``device='cpu'``).
* ``models/llama.py`` -- config, presets, weights, ``rms_norm``, ``rope``.
* ``models/quantization.py`` -- int8 weight-only quantization.
* ``models/sampling.py`` -- temperature / top-k / top-p sampling.
* ``models/generate.py`` -- KV cache, cached forward, ``generate``.
* ``ops/decode_attention.py`` + ``csrc/decode_attention.cu`` -- the
  flash-decode kernel.
* ``models/engine.py`` -- the continuous-batching engine (slot layout).
* ``observability/profiler.py`` -- the program ledger, device memory and
  the cold-start phase ledger.
* ``serve/llm_server.py`` -- the HTTP replica: the engine by default, the
  window-batching path for ``--engine off`` and seeded requests, and the
  fleet contract: ``serve/qos.py`` (admission), ``serve/metrics.py``
  (``/metrics``), ``serve/warmup.py``, ``utils/cuda_client_guard.py``.
* ``ops/attention.py`` + ``csrc/flash_attention*.cu*`` and ``train/`` --
  the flash-attention kernels and the trainer.
"""
