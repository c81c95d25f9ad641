"""The JAX package's example flows as port modules (counterparts of
``examples/mnist_sparse.py`` and ``examples/mnist_qat.py``), each run
with ``python -m spconv_tpu_torch.examples.<name>``; ``main(device=None,
steps=...)`` runs on the CUDA card unless the caller passes
``device="cpu"``."""
