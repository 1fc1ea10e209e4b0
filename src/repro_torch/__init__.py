"""repro_torch — the PyTorch/CUDA port of the ``repro`` JAX package.

Mirrors ``src/repro/`` module for module, for one NVIDIA Hopper GPU.
This slice serves the m-agent linear-regression fleet: the spec-string
policies, the triggered train step (homogeneous and ``hybrid``
dispatch), the fleet session and the ``gain_reduce`` CUDA kernel.  The
package imports no JAX and nothing of ``repro``; ``repro_torch.convert``
carries the JAX package's state and data across for the parity tests.

Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``, where the kernels' plain versions run.
"""
