"""PyTorch/CUDA port of the ``skypilot_tpu`` compute stack.

The JAX package ``skypilot_tpu`` stays the reference; this package mirrors
its module names and public layouts (``[B, S, H, D]`` activations,
``[L, B, Hkv, M, D]`` caches, stacked ``[L, ...]`` weights) and replaces
each Pallas TPU kernel with a CUDA kernel written for Hopper (``sm_90a``).

It imports ``torch`` and never ``jax``, and nothing of ``skypilot_tpu``:
what it needs from there it keeps as its own copy.

Ported so far (the serving window path):

* ``utils/device.py`` -- device resolution (CUDA unless ``device='cpu'``).
* ``models/llama.py`` -- config, presets, weights, ``rms_norm``, ``rope``.
* ``models/quantization.py`` -- int8 weight-only quantization.
* ``models/sampling.py`` -- temperature / top-k / top-p sampling.
* ``models/generate.py`` -- KV cache, cached forward, ``generate``.
* ``ops/decode_attention.py`` + ``csrc/decode_attention.cu`` -- the
  flash-decode kernel.
* ``serve/llm_server.py`` -- the window-batching HTTP replica.
"""
