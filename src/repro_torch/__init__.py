"""PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

Modules mirror ``repro``'s paths (``repro.kernels.ops`` ->
``repro_torch.kernels.ops``).  The package imports ``torch`` and never
``jax`` or ``repro``; entry points run on the CUDA card unless the
caller passes ``device="cpu"``, where each kernel's plain PyTorch version
runs instead.
"""
