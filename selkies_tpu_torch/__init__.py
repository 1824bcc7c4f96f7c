"""selkies_tpu_torch: the PyTorch/CUDA port of selkies-tpu's device half.

A second package beside ``selkies_tpu`` (the JAX reference, which it never
imports). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; see ``selkies_tpu_torch.device``.
"""
