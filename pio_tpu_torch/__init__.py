"""pio_tpu_torch — the PyTorch/CUDA port of ``pio_tpu``.

It runs the same DASE engines with PyTorch in place of JAX, and every
kernel that ``pio_tpu`` wrote in Pallas for the TPU becomes a CUDA C++
kernel written by hand for Hopper (``sm_90a``). It imports neither JAX nor
any module of ``pio_tpu``: framework-neutral modules it needs are kept as
its own copies, under the same module names, so each module's counterpart
in ``pio_tpu`` is found by its path.

Ported so far: the recommendation engine's train → deploy → query path
(ALS in every accumulation mode of the reference; exact and two-stage
clustered retrieval) and the sequence engine's (SASRec on one device),
with every Pallas kernel of ``pio_tpu`` as a CUDA kernel under
``ops/kernels/``. Entry points run on the CUDA device
unless the caller passes ``device="cpu"`` (``--device cpu``); without a
card and without that request they raise.
"""

__version__ = "0.1.0"
