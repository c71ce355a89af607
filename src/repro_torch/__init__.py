"""PyTorch/CUDA port of the LLMSched serving stack (``repro``'s twin).

Mirrors the JAX package module by module: ``models`` (config, layers,
the dense transformer subset and the paged model path), ``kernels``
(plain PyTorch versions beside hand-written CUDA kernels for Hopper,
behind the ``ops`` dispatch), ``serving`` (the paged continuous-batching
engine with its page allocator and prefix index), ``core`` (the measured
l(b) profile) and ``analysis`` (the KV-page sanitizer).

The port imports ``torch``, numpy and the standard library only — never
``jax`` and nothing of ``repro``.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""
